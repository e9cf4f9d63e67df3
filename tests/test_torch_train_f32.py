"""The training path's float32 twins against the reference, on the CPU:
the five configs of `tests/test_torch_train.py` with float32 parameters,
where every op computes in float32 on both sides, so the comparison is
tight enough that any difference of semantics fails (a mask, a remat
recompute, the straight-through estimator's operands, a loss term).

Tolerances (measured on these inputs): logits within 2.9e-6 (moonshot;
FLOAT32_ATOL = 2e-5, the families tests' float32 bound), loss within
4.8e-7 (LOSS_ATOL = 4e-6), every gradient leaf within 6.0e-6 of its largest
|gradient| (mamba2; GRAD_RTOL = 3e-5): the two libraries sum their
matmuls and reductions in different orders.
"""
import pytest

import _train_compare as tc

FLOAT32_ATOL = 2e-5
LOSS_ATOL = 4e-6
GRAD_RTOL = 3e-5


@pytest.mark.parametrize("name", tc.TRAIN_CONFIGS)
def test_float32_forward_loss_and_grads_match_reference(name):
    tc.check(name, "float32", lambda m: FLOAT32_ATOL, LOSS_ATOL, GRAD_RTOL)
