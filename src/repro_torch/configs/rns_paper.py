"""The paper's RNS-accelerator LM, port of the `rns-smollm-135m-fused`
entries of `repro/configs/rns_paper.py`: the smollm backbone with every
linear on the fused RNS kernel and the weights encoded once at load."""
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


register("rns-smollm-135m-fused", full_fused, smoke_fused)
