"""The port's flash-attention forward against the JAX package's.

The JAX route is the Pallas kernel itself (``_flash_fwd_bhsd``), run in
the Pallas interpreter as ``tests/test_flash_attention.py`` runs it; the
port route is the Hopper kernel's plain PyTorch version, which is what
``flash_attention_fwd`` runs on CPU tensors. Inputs are numpy-seeded and
shared. The kernel itself runs only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu.nn.functional.flash_attention import _sdpa_xla
from paddle_tpu_torch.nn.functional.flash_attention import (
    _sdpa_plain, flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)

# fp32 on both sides; the two differ only in summation order
ATOL = RTOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _qkv(b, s_q, s_k, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s_q, h, d).astype(np.float32),
            rng.randn(b, s_k, h, d).astype(np.float32),
            rng.randn(b, s_k, h, d).astype(np.float32))


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_k", [(128, 128), (17, 128), (100, 64),
                                     (100, 100)],
                         ids=["equal", "sq_lt_sk", "sq_gt_sk", "unaligned"])
def test_plain_matches_pallas_kernel(s_q, s_k, causal, d):
    b, h = 1, 2
    q, k, v = _qkv(b, s_q, s_k, h, d)
    scale = 1.0 / math.sqrt(d)
    j_out, j_lse = jfa._flash_fwd_bhsd(_bhsd(q), _bhsd(k), _bhsd(v),
                                       causal=causal, scale=scale,
                                       block_q=64, block_k=64)
    j_out = np.asarray(j_out).reshape(b, h, s_q, d).transpose(0, 2, 1, 3)
    j_lse = np.asarray(j_lse)[:, :s_q, 0].reshape(b, h, s_q)

    out, lse = flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale)
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL, rtol=RTOL)
    # LSE is compared on the rows that see at least one key
    rows = np.arange(s_q)
    seen = rows + (s_k - s_q) >= 0 if causal else rows >= 0
    np.testing.assert_allclose(lse.numpy()[:, :, seen], j_lse[:, :, seen],
                               atol=ATOL, rtol=RTOL)
    if causal and not seen.all():
        assert np.all(out.numpy()[:, ~seen] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_wrapper_runs_plain_version(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 33, 33, 3, 64, seed=1))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    assert flash_attention_fwd.launches == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_functional_matches_jax_sdpa(causal):
    """The port's F.flash_attention on CPU tensors against the JAX
    package's plain attention (what its F.flash_attention runs off-TPU)."""
    q, k, v = _qkv(2, 40, 40, 4, 16, seed=2)
    ref = np.asarray(_sdpa_xla(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal))
    out, none = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    assert none is None
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_sdpa_with_mask_matches_jax(mask_kind):
    q, k, v = _qkv(1, 24, 24, 2, 16, seed=3)
    rng = np.random.RandomState(4)
    keep = rng.rand(1, 2, 24, 24) > 0.3
    keep[..., 0] = True
    if mask_kind == "bool":
        j_bias = np.where(keep, 0.0, -1e30).astype(np.float32)
        t_mask = torch.from_numpy(keep)
    else:
        j_bias = rng.randn(1, 2, 24, 24).astype(np.float32)
        t_mask = torch.from_numpy(j_bias)
    ref = np.asarray(_sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bias=jnp.asarray(j_bias)))
    out = scaled_dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), attn_mask=t_mask)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    plain = _sdpa_plain(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v),
                        bias=torch.from_numpy(j_bias))
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=RTOL)
