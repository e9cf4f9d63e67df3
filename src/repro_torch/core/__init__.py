"""The port's RNS core: plans, quantizer, residue tensors, the RNS linear.

The exported names are the reference's (`repro/core/__init__.py`), name for
name.
"""
from .channel_plan import ChannelPlan  # noqa: F401
from .conversion_plan import ConversionPlan  # noqa: F401
from .linear_spec import LinearSpec  # noqa: F401
from .quant import QMAX, dequantize, quantize_int8, requant_scale  # noqa: F401
from .rns import (  # noqa: F401
    RNSBasis,
    basis_for_accumulation,
    basis_for_chain,
    basis_for_int8_matmul,
    paper_n5_basis,
    tau_basis,
)
from .rns_linear import (  # noqa: F401
    reconstruct_mrc,
    rns_chain_linear,
    rns_dense,
    rns_int_matmul,
)
from .rns_tensor import (  # noqa: F401
    RNSTensor,
    encode,
    encode_activation,
    encode_params,
)

__all__ = [
    "ChannelPlan",
    "ConversionPlan",
    "LinearSpec",
    "QMAX",
    "RNSBasis",
    "RNSTensor",
    "basis_for_accumulation",
    "basis_for_chain",
    "basis_for_int8_matmul",
    "dequantize",
    "encode",
    "encode_activation",
    "encode_params",
    "paper_n5_basis",
    "quantize_int8",
    "reconstruct_mrc",
    "requant_scale",
    "rns_chain_linear",
    "rns_dense",
    "rns_int_matmul",
    "tau_basis",
]
