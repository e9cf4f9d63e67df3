"""The paper's RNS-accelerator LM, port of the `rns-smollm-135m-{fused,
resident,pallas}` entries of `repro/configs/rns_paper.py`: the smollm
backbone with every linear on the RNS datapath.

  -fused    — one fused-kernel launch per linear, weights encoded once at
              load;
  -resident — the fused cell with residue-domain residency: stacked QKV in
              one residue-in launch, the GLU MLP chained up → in-domain
              gate → down with one activation encode and one MRC exit;
  -pallas   — live weights on the staged kernels: per call, the weight's
              quantize and forward conversion, the broadcast channel matmul
              and the MRC reverse.
"""
import dataclasses

from . import smollm_135m
from .base import ModelConfig, register


def full_fused() -> ModelConfig:
    return dataclasses.replace(smollm_135m.full(),
                               name="rns-smollm-135m-fused",
                               linear_backend="rns_int8:pallas_fused",
                               encode_weights=True)


def smoke_fused() -> ModelConfig:
    return dataclasses.replace(smollm_135m.smoke(),
                               name="rns-smollm-smoke-fused",
                               linear_backend="rns_int8:pallas_fused",
                               encode_weights=True)


def full_resident() -> ModelConfig:
    return dataclasses.replace(full_fused(), name="rns-smollm-135m-resident",
                               linear_domain="residue")


def smoke_resident() -> ModelConfig:
    return dataclasses.replace(smoke_fused(),
                               name="rns-smollm-smoke-resident",
                               linear_domain="residue")


def full_pallas() -> ModelConfig:
    return dataclasses.replace(smollm_135m.full(),
                               name="rns-smollm-135m-pallas",
                               linear_backend="rns_int8:pallas")


def smoke_pallas() -> ModelConfig:
    return dataclasses.replace(smollm_135m.smoke(),
                               name="rns-smollm-smoke-pallas",
                               linear_backend="rns_int8:pallas")


register("rns-smollm-135m-fused", full_fused, smoke_fused)
register("rns-smollm-135m-resident", full_resident, smoke_resident)
register("rns-smollm-135m-pallas", full_pallas, smoke_pallas)
