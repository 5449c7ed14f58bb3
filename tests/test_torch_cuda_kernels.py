"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports torch and the port only (no JAX), so it also runs on a
machine that has a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_delta, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)

# fp32 sums in another order; bf16/fp16: one rounding step of the output
TOLERANCES = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
# backward: fp32 max abs error (sums of up to S products in another order);
# bf16/fp16 norm-wise relative error (P and dS are rounded to the input
# type before their products, as on the TPU, and the plain version is fp32)
BWD_TOLERANCES = {torch.float32: 2e-4, torch.bfloat16: 1e-2,
                  torch.float16: 2e-3}


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
    # a CUDA input that requires grad trains through K1, K2 and K3
    counts = (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    out, _ = flash_attention_fwd(y, y, y, causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    assert y.grad is not None and bool(torch.isfinite(y.grad).all())
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        flash_attention_fwd(y.detach(), y.detach().cpu(), y.detach())


def _bwd_inputs(b, s_q, s_k, h, d, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, do = (torch.randn((b, s_q, h, d), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s_k, h, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    return q, k, v, do


def _bwd_error(got, ref, dtype):
    """fp32: max abs error; bf16/fp16: norm-wise relative error."""
    diff = got.float() - ref.float()
    if dtype == torch.float32:
        return diff.abs().max().item()
    return (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()


def _check_bwd(q, k, v, do, causal, dtype):
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    delta = flash_attention_bwd_delta(out, do)
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    tol = BWD_TOLERANCES[dtype]
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.is_contiguous() and got.dtype == dtype
        err = _bwd_error(got, want, dtype)
        assert err <= tol, f"{name}: error {err} over {tol}"
    s_q, s_k = q.shape[1], k.shape[1]
    rows = torch.arange(s_q, device="cuda")
    blind = rows + (s_k - s_q) < 0 if causal else rows < 0
    if bool(blind.any()):                    # rows that see no key
        assert dq[:, blind].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(BWD_TOLERANCES, key=str))
@pytest.mark.parametrize("s_q,s_k,d,causal", [
    (130, 130, 64, True), (130, 130, 64, False), (17, 300, 64, True),
    (90, 40, 64, True), (200, 200, 128, True), (150, 70, 128, False)])
def test_flash_attention_bwd_matches_plain(s_q, s_k, d, causal, dtype):
    _card()
    q, k, v, do = _bwd_inputs(2, s_q, s_k, 3, d, dtype, s_q * 5 + s_k)
    _check_bwd(q, k, v, do, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_reads_strided_qkv_views(dtype):
    """K2 and K3 read q/k/v as views into one qkv projection, and a dO
    that is a strided view too."""
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    qkv = torch.randn((2, 77, 3 * 4 * 64), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.view(2, 77, 4, 64) for t in qkv.split(4 * 64, dim=-1))
    do = torch.randn((2, 77, 4, 2 * 64), generator=gen,
                     device="cuda").to(dtype)[..., :64]
    assert not q.is_contiguous() and not do.is_contiguous()
    _check_bwd(q, k, v, do, True, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_plain_autograd(causal):
    """Gradients through the autograd Function (K1, then K2 and K3)
    against torch autograd through the plain forward, fp32."""
    _card()
    q, k, v, _ = _bwd_inputs(2, 96, 96, 2, 64, torch.float32, 7)

    def loss(fn, q, k, v):
        out = fn(q, k, v, causal=causal)[0]
        return (out * torch.cos(out)).sum()       # a non-trivial cotangent

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(loss(flash_attention_fwd, *leaves), leaves)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(loss(flash_attention_fwd_plain, *leaves),
                               leaves)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= BWD_TOLERANCES[torch.float32]
