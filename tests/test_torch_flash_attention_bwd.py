"""The port's flash-attention backward against the JAX package's.

The JAX route is the Pallas backward kernels themselves (``_dq_kernel``
and ``_dkv_kernel`` through ``_flash_bwd_bhsd``, fed by
``_flash_fwd_bhsd``), run in the Pallas interpreter as
``tests/test_flash_attention.py`` runs them; the port route is the
backward kernels' plain PyTorch version, which is what the K2/K3
wrappers and the autograd Function run on CPU tensors. Inputs are
numpy-seeded and shared; the kernels themselves run only on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu_torch.nn.functional import (flash_attention,
                                            scaled_dot_product_attention)
from paddle_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_delta, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_fwd)

# the JAX package's own backward tolerance (tests/test_flash_attention.py)
ATOL, RTOL = 5e-5, 5e-4


@pytest.fixture(autouse=True)
def _interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _arrays(b, s_q, s_k, h, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s_q, h, d).astype(np.float32),
            rng.randn(b, s_k, h, d).astype(np.float32),
            rng.randn(b, s_k, h, d).astype(np.float32),
            rng.randn(b, s_q, h, d).astype(np.float32))


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _bshd(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("d,block_k", [(16, 32), (64, 64), (128, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_k", [(128, 128), (17, 128), (100, 64),
                                     (100, 100)],
                         ids=["equal", "sq_lt_sk", "sq_gt_sk", "unaligned"])
def test_plain_matches_pallas_kernels(s_q, s_k, causal, d, block_k):
    b, h = 1, 2
    q, k, v, do = _arrays(b, s_q, s_k, h, d, seed=s_q + s_k + d)
    scale = 1.0 / math.sqrt(d)
    blocks = dict(block_q=64, block_k=block_k)
    j_out, j_lse = jfa._flash_fwd_bhsd(_bhsd(q), _bhsd(k), _bhsd(v),
                                       causal=causal, scale=scale, **blocks)
    j_grads = jfa._flash_bwd_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), j_out, j_lse,
                                  _bhsd(do), causal=causal, scale=scale,
                                  **blocks)

    # the port's backward gets the same forward outputs
    out = torch.from_numpy(_bshd(j_out, b, h).copy())
    lse = torch.from_numpy(np.array(j_lse)[:, :s_q, 0].reshape(b, h, s_q))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    grads = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                      causal=causal, scale=scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, j_grads):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b, h),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} mismatch")
    rows = np.arange(s_q)
    if causal and (rows + s_k - s_q < 0).any():       # rows that see no key
        assert np.all(grads[0].numpy()[:, rows + s_k - s_q < 0] == 0.0)

    # on CPU tensors the K2/K3 wrappers are the plain version, and
    # nothing launches
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    delta = flash_attention_bwd_delta(out, tdo)
    dq = flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta, causal=causal,
                                scale=scale)
    dk, dv = flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta,
                                     causal=causal, scale=scale)
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("entry", ["flash_attention", "sdpa"])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad(causal, entry):
    """torch.autograd.grad through the port's functional (the autograd
    Function, plain versions on CPU) against jax.grad through the JAX
    package's custom_vjp (its Pallas kernels, interpreted)."""
    b, s, h, d = 2, 96, 2, 64
    q, k, v, _ = _arrays(b, s, s, h, d, seed=11)

    def j_loss(q, k, v):
        out = jfa.flash_attention_fwd(q, k, v, causal=causal, block_q=64,
                                      block_k=64)
        return jnp.sum(out * jnp.cos(out))        # a non-trivial cotangent

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = [flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches]
    if entry == "flash_attention":
        out, _ = flash_attention(*leaves, causal=causal)
    else:
        out = scaled_dot_product_attention(*leaves, is_causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    grads = torch.autograd.grad((out * torch.cos(out)).sum(), leaves)
    for name, got, want in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name} mismatch")
    assert before == [flash_attention_fwd.launches,
                      flash_attention_bwd_dq.launches,
                      flash_attention_bwd_dkv.launches]     # a CPU call


def test_no_grad_call_skips_the_function():
    """Under inference_mode (the serving path) the call is K1's wrapper
    alone: no autograd node, nothing saved."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_()
                  for x in _arrays(1, 8, 8, 1, 64, seed=3))
    with torch.inference_mode():
        out, lse = flash_attention_fwd(q, k, v, causal=True)
    assert out.grad_fn is None and lse.grad_fn is None
