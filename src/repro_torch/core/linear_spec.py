"""LinearSpec: the structured description of a linear layer's datapath,
port of `repro/core/linear_spec.py`.

  * ``mode``           — "bf16" (plain matmul) or "rns_int8" (the residue
                         channel integer matmul);
  * ``backend``        — "pallas_fused" (one fused-kernel launch per linear,
                         `kernels/rns_fused.py`), "pallas" (the staged
                         kernels: forward conversion, channel matmul, MRC
                         reverse) or "auto", which is "pallas_fused";
  * ``broadcast``      — broadcast-operand datapath (raw signed int8
                         activations against weight residues); False is
                         the paper-literal per-channel datapath (both
                         operands converted, on the staged kernels);
  * ``encode_weights`` — the weights are encoded to residues once at load;
  * ``domain``         — "float" (each linear enters and leaves the residue
                         domain) or "residue" (stacked QKV and the GLU MLP
                         hand residues from launch to launch; needs encoded
                         weights);
  * ``dist``           — the layout preference of sharded serving
                         (`repro_torch.dist`): "none", "auto" (per launch
                         by wire bytes, `dist.comms`), "channel" (split the
                         residue channels over "model"; only the summed CRT
                         limb planes cross) or "column" (split the output
                         columns, gathered at the exit).  Anything but
                         "none" needs the RNS mode.

The reference's "jnp" backend (plain XLA ops) has no counterpart: the port's
plain versions run only on CPU tensors.
"""
from __future__ import annotations

import dataclasses
import functools

__all__ = ["LinearSpec", "BACKENDS"]

_MODES = ("bf16", "rns_int8")
BACKENDS = ("auto", "pallas", "pallas_fused")


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    mode: str = "bf16"
    backend: str = "auto"
    broadcast: bool = True
    encode_weights: bool = False
    domain: str = "float"
    dist: str = "none"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown linear mode {self.mode!r} "
                             f"(expected one of {_MODES})")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.domain not in ("float", "residue"):
            raise ValueError(f"domain must be 'float' or 'residue', "
                             f"got {self.domain!r}")
        if self.domain == "residue" and not (self.is_rns
                                             and self.encode_weights):
            raise ValueError("domain='residue' needs mode='rns_int8' with "
                             "encode_weights=True: residue-resident chains "
                             "consume weights encoded in the chain basis")
        if self.dist not in ("none", "auto", "channel", "column"):
            raise ValueError(f"dist must be 'none', 'auto', 'channel' or "
                             f"'column', got {self.dist!r}")
        if self.dist != "none" and not self.is_rns:
            raise ValueError("dist layouts shard the RNS launches; a bf16 "
                             "linear has none: use mode='rns_int8' or "
                             "dist='none'")

    @classmethod
    def parse(cls, spec) -> "LinearSpec":
        """A LinearSpec passes through; "bf16" and
        "rns_int8[:auto|pallas|pallas_fused]" map onto specs."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return _parse_str(spec)
        raise ValueError(f"unknown linear backend {spec!r} "
                         "(expected a LinearSpec or a backend string)")

    @property
    def is_rns(self) -> bool:
        return self.mode == "rns_int8"



@functools.lru_cache(maxsize=64)
def _parse_str(spec: str) -> LinearSpec:
    name, _, backend = spec.partition(":")
    if name == "rns_int8":
        return LinearSpec(mode="rns_int8", backend=backend or "auto")
    if name != "bf16" or backend:
        raise ValueError(f"unknown linear backend {spec!r} (expected bf16 | "
                         f"rns_int8[:{'|'.join(BACKENDS)}])")
    return LinearSpec()
