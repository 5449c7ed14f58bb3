"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports torch and the port only (no JAX), so it also runs on a
machine that has a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)

# fp32 sums in another order; bf16/fp16: one rounding step of the output
TOLERANCES = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOLERANCES, key=str))
@pytest.mark.parametrize("s_q,s_k,d,causal", [
    (130, 130, 64, True), (130, 130, 64, False), (1, 300, 64, True),
    (90, 40, 64, True), (200, 200, 128, True)])
def test_flash_attention_fwd_matches_plain(s_q, s_k, d, causal, dtype):
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(s_q * 7 + s_k)
    q = torch.randn((2, s_q, 4, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, s_k, 4, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2, s_k, 4, d), generator=gen, device="cuda").to(dtype)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    tol = TOLERANCES[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= tol
    rows = torch.arange(s_q, device="cuda")
    seen = rows + (s_k - s_q) >= 0 if causal else rows >= 0
    assert (lse - ref_lse)[:, :, seen].abs().max().item() <= tol
    if (~seen).any():                       # rows that see no key give 0
        assert out[:, ~seen].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_attention_fwd_reads_strided_qkv_views():
    """The GPT layer hands the kernel views into one qkv projection."""
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qkv = torch.randn((2, 77, 3 * 4 * 64), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(2, 77, 4, 64) for t in qkv.split(4 * 64, dim=-1))
    assert not q.is_contiguous()
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    ref, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_attention_fwd_rejects_what_it_does_not_take():
    _card()
    x = torch.randn((1, 8, 2, 32), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(x, x, x)
    y = torch.randn((1, 8, 2, 64), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="training slice"):
        flash_attention_fwd(y, y, y)
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        flash_attention_fwd(y.detach(), y.detach().cpu(), y.detach())
