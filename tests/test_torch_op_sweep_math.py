"""The op sweep of the elementwise math ops: each recipe of ``tests/test_op_sweep.py``
run through the JAX package and the port (``tests/torch_op_sweep.py``
says what is compared and at which tolerance: the recipe's own in fp32,
GRAD_RTOL on gradients, BF16_TOL in bf16)."""
import pytest

import torch_op_sweep as sweep

CATEGORIES = ("math",)


@pytest.mark.parametrize("name", sweep.swept(CATEGORIES))
def test_fp32(name):
    sweep.check_fp32(name)


@pytest.mark.parametrize("name", sweep.bf16_swept(CATEGORIES))
def test_bf16(name):
    sweep.check_bf16(name)


def test_registry_covers_the_jax_package():
    """Every name of the JAX registry is in the port's, under the same
    category."""
    missing = sorted(set(sweep.JOPS) - set(sweep.POPS))
    assert not missing, missing
    moved = sorted(n for n in sweep.JOPS
                   if sweep.POPS[n].category != sweep.JOPS[n].category)
    assert not moved, moved
