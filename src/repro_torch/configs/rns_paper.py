"""The paper's RNS-accelerator LM, port of `repro/configs/rns_paper.py`:
the smollm backbone with every linear on the RNS datapath.

  (none)    — `rns-smollm-135m`: live weights on the ``auto`` backend (the
              fused kernel), each linear quantizing its weight per call;
  -encoded  — the same backend with the weights encoded once at load;
  -fused    — one fused-kernel launch per linear, weights encoded once at
              load;
  -resident — the fused cell with residue-domain residency: stacked QKV in
              one residue-in launch, the GLU MLP chained up → in-domain
              gate → down with one activation encode and one MRC exit;
  -pallas   — live weights on the staged kernels: per call, the weight's
              quantize and forward conversion, the broadcast channel matmul
              and the MRC reverse;
  -sharded  — the fused cell with the "channel" layout preference of
              sharded serving (`repro_torch.dist`): built with a mesh, the
              Engine splits every launch's residue channels over "model",
              each rank folding its own slice and one all-reduce of the
              (L1, M, N) CRT limb planes combining them; without a mesh it
              serves as `-fused` does;
  -resident-sharded — residue residency and the channel preference: the
              chain interior (``emit="residues"``) replicates, each chain's
              float exit pays the one limb all-reduce.
"""
import dataclasses

from . import smollm_135m
from .base import ModelConfig, register


def full() -> ModelConfig:
    return dataclasses.replace(smollm_135m.full(), name="rns-smollm-135m",
                               linear_backend="rns_int8")


def smoke() -> ModelConfig:
    return dataclasses.replace(smollm_135m.smoke(), name="rns-smollm-smoke",
                               linear_backend="rns_int8")


def full_encoded() -> ModelConfig:
    return dataclasses.replace(full(), name="rns-smollm-135m-encoded",
                               encode_weights=True)


def smoke_encoded() -> ModelConfig:
    return dataclasses.replace(smoke(), name="rns-smollm-smoke-encoded",
                               encode_weights=True)


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


def full_sharded() -> ModelConfig:
    return dataclasses.replace(full_fused(), name="rns-smollm-135m-sharded",
                               dist_layout="channel")


def smoke_sharded() -> ModelConfig:
    return dataclasses.replace(smoke_fused(), name="rns-smollm-smoke-sharded",
                               dist_layout="channel")


def full_resident_sharded() -> ModelConfig:
    return dataclasses.replace(full_resident(),
                               name="rns-smollm-135m-resident-sharded",
                               dist_layout="channel")


def smoke_resident_sharded() -> ModelConfig:
    return dataclasses.replace(smoke_resident(),
                               name="rns-smollm-smoke-resident-sharded",
                               dist_layout="channel")


register("rns-smollm-135m", full, smoke)
register("rns-smollm-135m-encoded", full_encoded, smoke_encoded)
register("rns-smollm-135m-fused", full_fused, smoke_fused)
register("rns-smollm-135m-resident", full_resident, smoke_resident)
register("rns-smollm-135m-pallas", full_pallas, smoke_pallas)
register("rns-smollm-135m-sharded", full_sharded, smoke_sharded)
register("rns-smollm-135m-resident-sharded", full_resident_sharded,
         smoke_resident_sharded)
