"""The port's CUDA kernels (K1-K7) against their plain PyTorch versions, on
the card.

This file imports torch and the port only (no JAX), so it also runs on a
machine that has a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import pytest
import torch

from paddle_tpu_torch.models import rope_rotate
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import fused_ops as FK
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
    (90, 40, 64, True), (200, 200, 128, True),
    # the bf16/fp16 body's edges: 128-row query tiles, 128-key tiles
    (129, 129, 64, True), (65, 65, 64, True), (1000, 1000, 64, True),
    (129, 129, 64, False), (1, 1024, 64, True), (17, 1024, 64, True),
    (300, 64, 64, True), (2048, 2048, 128, True), (17, 1024, 128, True),
    (1000, 1000, 128, False)])
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("s,d", [(77, 64), (333, 128)])
def test_flash_attention_fwd_reads_strided_qkv_views(s, d, dtype):
    """The GPT layer hands the kernel views into one qkv projection (a
    sequence stride of 3*H*d, which the kernel's tensor maps take)."""
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qkv = torch.randn((2, s, 3 * 4 * d), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.view(2, s, 4, d) for t in qkv.split(4 * d, dim=-1))
    assert not q.is_contiguous()
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    ref, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCES[dtype]


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
    (90, 40, 64, True), (200, 200, 128, True), (150, 70, 128, False),
    # the bf16/fp16 bodies' tiles: K2 128 query rows and 128 (d = 64) or
    # 64 (d = 128) keys, K3 128 keys and 64 query rows
    (127, 127, 64, True), (129, 129, 64, True), (257, 257, 64, False),
    (127, 127, 128, False), (129, 129, 128, True), (257, 257, 128, True),
    # s_q < s_k across a 128-key boundary; s_q > s_k with blind rows
    (100, 200, 64, True), (60, 140, 128, True), (200, 70, 128, True),
    (300, 129, 128, True)])
def test_flash_attention_bwd_matches_plain(s_q, s_k, d, causal, dtype):
    _card()
    q, k, v, do = _bwd_inputs(2, s_q, s_k, 3, d, dtype, s_q * 5 + s_k)
    _check_bwd(q, k, v, do, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.float16, 128)])
def test_flash_attention_bwd_reads_strided_qkv_views(dtype, d):
    """K2 and K3 read q/k/v as views into one qkv projection, and a dO
    that is a strided view too."""
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    qkv = torch.randn((2, 77, 3 * 4 * d), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (t.view(2, 77, 4, d) for t in qkv.split(4 * d, dim=-1))
    do = torch.randn((2, 77, 4, 2 * d), generator=gen,
                     device="cuda").to(dtype)[..., :d]
    assert not q.is_contiguous() and not do.is_contiguous()
    _check_bwd(q, k, v, do, True, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_bwd_reads_a_broadcast_do(dtype):
    """dO as a broadcast view (strides 0, 0, 0, 1), as autograd hands over
    the gradient of out.sum((0, 1, 2)): the tensor maps take zero strides."""
    _card()
    q, k, v, _ = _bwd_inputs(2, 77, 77, 4, 64, dtype, 3)
    do = torch.randn(64, device="cuda").to(dtype).expand(2, 77, 4, 64)
    _check_bwd(q, k, v, do, True, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bwd_is_deterministic(d, dtype):
    """Two calls of K2 and K3 give bitwise-equal dq, dk and dv: each sum
    runs inside one block in one order, with no atomics."""
    _card()
    q, k, v, do = _bwd_inputs(2, 333, 333, 3, d, dtype, d)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    delta = flash_attention_bwd_delta(out, do)
    runs = [(flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), f"{name} differs between two calls"


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


# ------------------------------------------------------------ K4 - K7
# Against the plain versions (fp32 inside, one rounding at the end): fp32
# max abs error, inputs unit-normal and weights scaled by 1/sqrt(K); bf16 /
# fp16 one rounding of the output, |got - ref| <= REL * |ref| + 1e-3 (both
# sides round an fp32 value that differs only in the order of its sums).
FUSED_FP32_TOL = 1e-4
FUSED_REL = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}
FUSED_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# K6's row pass in bf16/fp16 against its plain version: fp32 statistics
# summed in another order, so a normalized value may be the neighbour in
# x's type, or within ROW_FP32_ABS where the norm bias cancels the scaled
# row near 0 (x's type is finer there than the terms' fp32 error); values
# not equal at most ROW_NEIGHBOURS of all, held where that allows 100
ROW_NEIGHBOURS = 1e-4
ROW_FP32_ABS = 2 ** -20


def _fused_ok(got, ref, dtype):
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        return diff.max().item() <= FUSED_FP32_TOL
    bound = FUSED_REL[dtype] * ref.float().abs() + 1e-3
    return bool((diff <= bound).all())


def _rows_ok(got, ref):
    """K6's row pass against the plain rows: every value equal, the
    neighbour in its type or within ROW_FP32_ABS; the values not equal
    at most ROW_NEIGHBOURS of all where that share is 100 or more."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    steps = (ordered(got) - ordered(ref)).abs()
    diff = (got.float() - ref.float()).abs()
    if bool(((steps > 1) & (diff > ROW_FP32_ABS)).any()):
        return False
    n = got.numel()
    return n * ROW_NEIGHBOURS < 100 or int((steps > 0).sum()) <= ROW_NEIGHBOURS * n


def _rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _gen(seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=str)
@pytest.mark.parametrize("rows,d,kind,affine", [
    (37, 200, "layer_norm", True), (64, 1536, "rms_norm", True),
    (5, 1024, "layer_norm", False), (9, 100, "rms_norm", False)])
def test_fused_residual_norm_matches_plain(rows, d, kind, affine, dtype):
    _card()
    gen = _gen(rows + d)
    x, r = _rand((rows, d), dtype, gen), _rand((rows, d), dtype, gen)
    w = (1 + _rand((d,), dtype, gen, 0.1)) if affine else None
    b = _rand((d,), dtype, gen, 0.1) if affine else None
    before = FK.fused_residual_norm.launches
    y, s = FK.fused_residual_norm(x, r, w, b, kind=kind, eps=1e-5)
    torch.cuda.synchronize()
    assert FK.fused_residual_norm.launches == before + 1
    ref_y, ref_s = FK.fused_residual_norm_plain(x, r, w, b, kind, 1e-5)
    assert _fused_ok(y, ref_y, dtype) and _fused_ok(s, ref_s, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=str)
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "silu", "relu", "none"])
@pytest.mark.parametrize("rows,d", [(33, 100), (64, 4096)])
def test_fused_bias_act_matches_plain(rows, d, act, dtype):
    _card()
    gen = _gen(rows * 3 + d)
    x, b = _rand((rows, d), dtype, gen), _rand((d,), dtype, gen, 0.5)
    got = FK.fused_bias_act(x, b, act=act)
    torch.cuda.synchronize()
    assert _fused_ok(got, FK.fused_bias_act_plain(x, b, act), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=str)
@pytest.mark.parametrize("m,k,n,norm_kind,act,with_bias", [
    (130, 72, 200, "layer_norm", "gelu_tanh", True),
    (256, 1024, 384, "", "gelu", True),
    (77, 136, 129, "rms_norm", "silu", False),
    (1, 64, 8, "", "relu", False),
    # the bf16/fp16 body's edges: 128 x 128 tiles, 64-wide k-tiles, rows
    # that are not 16-byte aligned when N % 8 != 0
    (300, 1024, 384, "layer_norm", "gelu_tanh", True),
    (64, 256, 4100, "", "gelu", True),
    (37, 128, 8, "rms_norm", "", False),
    (50, 8, 136, "", "silu", True),
    (1, 1024, 256, "rms_norm", "relu", True),
    (129, 72, 129, "", "gelu_tanh", False)])
def test_fused_matmul_matches_plain(m, k, n, norm_kind, act, with_bias,
                                    dtype):
    _card()
    gen = _gen(m + k + n)
    x = _rand((m, k), dtype, gen)
    w = _rand((n, k), dtype, gen, k ** -0.5)
    b = _rand((n,), dtype, gen, 0.1) if with_bias else None
    nw = (1 + _rand((k,), dtype, gen, 0.1)) if norm_kind else None
    nb = _rand((k,), dtype, gen, 0.1) if norm_kind else None
    before = FK.fused_matmul.launches
    got = FK.fused_matmul(x, w, b, nw, nb, norm_kind=norm_kind, act=act)
    torch.cuda.synchronize()
    assert FK.fused_matmul.launches == before + 1
    if norm_kind and dtype != torch.float32:
        # the row pass and the product held apart: (a) the rows equal to
        # the plain rows or their neighbours, (b) the product against the
        # plain product of the kernel's own rows
        rows = FK.fused_norm_rows(x, nw, nb, norm_kind)
        assert _rows_ok(rows, FK.fused_norm_rows_plain(x, nw, nb, norm_kind))
        ref = FK.fused_matmul_plain(rows, w, b, act=act)
    else:
        ref = FK.fused_matmul_plain(x, w, b, nw, nb, norm_kind, act)
    assert _fused_ok(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("m,k,kind,affine", [
    (130, 72, "layer_norm", True), (64, 1536, "rms_norm", True),
    (1, 1024, "layer_norm", False), (300, 136, "rms_norm", False),
    # where 1e-4 of the values is 100 or more, the share is held too
    (2048, 1024, "layer_norm", True), (1024, 1536, "rms_norm", True)])
def test_fused_norm_rows_matches_plain(m, k, kind, affine, dtype):
    """K6's row pass on its own, as ``_rows_ok``."""
    _card()
    gen = _gen(m * 7 + k)
    x = _rand((m, k), dtype, gen, 2.0)
    nw = (1 + _rand((k,), dtype, gen, 0.1)) if affine else None
    nb = _rand((k,), dtype, gen, 0.1) if affine else None
    before = FK.fused_norm_rows.launches
    got = FK.fused_norm_rows(x, nw, nb, kind)
    torch.cuda.synchronize()
    assert FK.fused_norm_rows.launches == before + 1
    ref = FK.fused_norm_rows_plain(x, nw, nb, kind)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    assert _rows_ok(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FUSED_DTYPES, ids=str)
@pytest.mark.parametrize("b_,s,k,heads,head_dim,pos_offset,with_bias", [
    (2, 33, 136, 3, 64, 5, True), (2, 64, 256, 2, 128, 0, False),
    (1, 2048, 128, 1, 128, 0, False),
    # the bf16/fp16 body's edges: 128 x 128 tiles (ragged M, N = 192),
    # 64-wide k-tiles (K = 136, K = 8), head dims 16 and 32, angles past
    # 6000 rad, the small LLaMA's GQA k projection
    (3, 100, 256, 2, 128, 0, True), (2, 64, 256, 3, 64, 0, False),
    (2, 80, 136, 3, 128, 2, False), (2, 40, 8, 2, 32, 0, True),
    (2, 50, 64, 4, 16, 3, True), (3, 100, 136, 3, 32, 9, False),
    (2, 2048, 256, 2, 128, 4000, False), (2, 512, 1024, 4, 128, 0, False)])
def test_fused_matmul_rope_matches_plain(b_, s, k, heads, head_dim,
                                         pos_offset, with_bias, dtype):
    _card()
    gen = _gen(s + k)
    n = heads * head_dim
    x = _rand((b_ * s, k), dtype, gen)
    w = _rand((n, k), dtype, gen, k ** -0.5)
    bias = _rand((n,), dtype, gen, 0.1) if with_bias else None
    before = FK.fused_matmul_rope.launches
    got = FK.fused_matmul_rope(x, w, bias, seq=s, head_dim=head_dim,
                               pos_offset=pos_offset)
    torch.cuda.synchronize()
    assert FK.fused_matmul_rope.launches == before + 1
    ref = FK.fused_matmul_rope_plain(x, w, bias, seq=s, head_dim=head_dim,
                                     pos_offset=pos_offset)
    assert _fused_ok(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("head_dim", [64, 128])
def test_fused_matmul_rope_is_deterministic(head_dim, dtype):
    """Two K7 calls give bitwise-equal outputs: each sum runs inside one
    block in one order, with no atomics."""
    _card()
    gen = _gen(head_dim)
    x = _rand((300, 512), dtype, gen)
    w = _rand((512, 512), dtype, gen, 512 ** -0.5)
    b = _rand((512,), dtype, gen, 0.1)
    runs = [FK.fused_matmul_rope(x, w, b, seq=150, head_dim=head_dim,
                                 pos_offset=11) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


@pytest.mark.cuda
def test_fused_kernels_raise_on_what_they_do_not_take():
    """No fallback: a CUDA tensor launches the kernel or raises."""
    _card()
    x = torch.randn((4, 12), device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        FK.fused_matmul(x, torch.randn((8, 12), device="cuda"))
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        FK.fused_norm_rows(x, kind="rms_norm")
    with pytest.raises(ValueError, match="multiple of 8"):
        FK.fused_norm_rows(x.half(), kind="rms_norm")
    with pytest.raises(ValueError, match="head_dim"):
        FK.fused_matmul_rope(torch.randn((4, 64), device="cuda"),
                             torch.randn((192, 64), device="cuda"), seq=4,
                             head_dim=96)
    with pytest.raises(TypeError, match="share one of"):
        FK.fused_bias_act(x, torch.zeros(12, device="cuda",
                                         dtype=torch.float16))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        FK.fused_residual_norm(x, x.cpu())
    with pytest.raises(ValueError, match="multiple of 8"):
        F.fused_norm_linear(torch.randn((2, 3, 12), device="cuda"),
                            torch.randn((8, 12), device="cuda"))


@pytest.mark.cuda
def test_fused_functionals_launch_forward_and_recompute_backward():
    """Forward through the kernel (one launch), backward through the
    composite (no launch), with the composite's gradients."""
    _card()
    gen = _gen(11)
    x = _rand((2, 16, 128), torch.float32, gen).requires_grad_()
    w = _rand((128, 128), torch.float32, gen, 128 ** -0.5).requires_grad_()
    before = FK.fused_matmul_rope.launches
    out = F.fused_rope_proj(x, w, num_heads=2, pos_offset=3)
    (out * torch.cos(out)).sum().backward()
    torch.cuda.synchronize()
    assert FK.fused_matmul_rope.launches == before + 1
    xr, wr = (t.detach().clone().requires_grad_() for t in (x, w))
    ref = rope_rotate((xr @ wr.t()).view(2, 16, 2, 64), 10000.0, 3)
    (ref * torch.cos(ref)).sum().backward()
    assert (out - ref).abs().max().item() <= FUSED_FP32_TOL
    assert (x.grad - xr.grad).abs().max().item() <= 1e-4
    assert (w.grad - wr.grad).abs().max().item() <= 1e-4


# ------------------------------------------- the Paddle-API fused ops
def _paddle(t):
    import paddle_tpu_torch as paddle
    return paddle.to_tensor(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_paddle_api_fused_ops_launch_their_kernels(dtype):
    """``F.fused_*`` on Paddle Tensors (through the dispatcher, Paddle's
    (in, out) weights) launch K4, K6 and K7 once each and match the plain
    versions within the FUSED_* limits; a residual of another dtype goes
    with x to their promoted dtype and launches K4 there."""
    _card()
    gen = _gen(21)
    rows, d, n = 256, 128, 192
    x, res = _rand((2, 128, d), dtype, gen), _rand((2, 128, d), dtype, gen)
    w, b = 1 + _rand((d,), dtype, gen, 0.1), _rand((d,), dtype, gen, 0.1)
    counts = (FK.fused_residual_norm.launches, FK.fused_matmul.launches,
              FK.fused_matmul_rope.launches)
    y, summed = F.fused_residual_norm(_paddle(x), _paddle(res), _paddle(w),
                                      _paddle(b))
    want_y, want_s = FK.fused_residual_norm_plain(
        x.reshape(rows, d), res.reshape(rows, d), w, b)
    assert _fused_ok(y._data.reshape(rows, d), want_y, dtype)
    assert _fused_ok(summed._data.reshape(rows, d), want_s, dtype)
    wl = _rand((d, n), dtype, gen, d ** -0.5)          # Paddle's (in, out)
    bl = _rand((n,), dtype, gen, 0.1)
    out = F.fused_norm_linear(_paddle(x), _paddle(wl), _paddle(bl),
                              activation="gelu", norm_type="")
    assert _fused_ok(out._data.reshape(rows, n), FK.fused_matmul_plain(
        x.reshape(rows, d), wl.t().contiguous(), bl, act="gelu"), dtype)
    wr = _rand((d, 2 * 64), dtype, gen, d ** -0.5)
    rot = F.fused_rope_proj(_paddle(x), _paddle(wr), num_heads=2,
                            pos_offset=3)
    assert _fused_ok(rot._data.reshape(rows, 2 * 64),
                     FK.fused_matmul_rope_plain(
                         x.reshape(rows, d), wr.t().contiguous(), seq=128,
                         head_dim=64, pos_offset=3), dtype)
    torch.cuda.synchronize()
    assert (FK.fused_residual_norm.launches, FK.fused_matmul.launches,
            FK.fused_matmul_rope.launches) == tuple(c + 1 for c in counts)
    if dtype == torch.float32:
        return
    before = FK.fused_residual_norm.launches
    y32, s32 = F.fused_residual_norm(_paddle(x.float()), _paddle(res),
                                     _paddle(w), _paddle(b))
    torch.cuda.synchronize()
    assert FK.fused_residual_norm.launches == before + 1
    assert y32.dtype == s32.dtype == torch.float32
    want_y, want_s = FK.fused_residual_norm_plain(
        x.float().reshape(rows, d), res.float().reshape(rows, d), w.float(),
        b.float())
    assert _fused_ok(y32._data.reshape(rows, d), want_y, torch.float32)
    assert _fused_ok(s32._data.reshape(rows, d), want_s, torch.float32)


@pytest.mark.cuda
def test_paddle_static_program_launches_the_fused_kernels():
    """bench.py's fusion block (small) in the Paddle API under to_static
    with fusion, fp32: the replay launches K4 once, K6 once and K7 twice,
    and equals the unfused eager block within FUSED_FP32_TOL."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, ops
    from paddle_tpu_torch.models import llama
    _card()
    b, s, h, ff, heads = 2, 64, 256, 512, 4
    with paddle.device_guard("gpu:0"):
        paddle.seed(0)
        q_proj, k_proj = nn.Linear(h, h), nn.Linear(h, h)
        ln2, fc1, fc2 = nn.LayerNorm(h), nn.Linear(h, ff), nn.Linear(ff, h)

        def block(xt):
            hn = F.rms_norm(xt)
            q = llama.rotary_embedding(ops.reshape(q_proj(hn),
                                                   [b, s, heads, h // heads]))
            k = llama.rotary_embedding(ops.reshape(k_proj(hn),
                                                   [b, s, heads, h // heads]))
            y = F.rms_norm(xt + fc2(F.gelu(fc1(ln2(xt)))))
            return y + ops.reshape(q, [b, s, h]) + ops.reshape(k, [b, s, h])
        rng = np.random.RandomState(0)
        xs = [paddle.to_tensor(rng.randn(b, s, h).astype(np.float32) * 0.5)
              for _ in range(2)]
        sf = paddle.jit.to_static(block, full_graph=True)
        paddle.set_flags({"FLAGS_enable_fusion": True})
        try:
            sf(xs[0])                                   # records
            counts = (FK.fused_residual_norm.launches,
                      FK.fused_matmul.launches, FK.fused_matmul_rope.launches)
            got = sf(xs[1])
            torch.cuda.synchronize()
        finally:
            paddle.set_flags({"FLAGS_enable_fusion": False})
        assert (FK.fused_residual_norm.launches, FK.fused_matmul.launches,
                FK.fused_matmul_rope.launches) == (counts[0] + 1,
                                                   counts[1] + 1,
                                                   counts[2] + 2)
        want = block(xs[1])
        assert (got._data - want._data).abs().max().item() <= FUSED_FP32_TOL


# ---------------------------------------------- amp, fused loss, recompute
@pytest.mark.cuda
@pytest.mark.parametrize("level,dtype", [("O1", "bfloat16"),
                                         ("O2", "float16")])
def test_amp_hands_the_kernels_their_dtype(level, dtype):
    """Under auto_cast, fp32 inputs reach K1 and the white-list fused ops
    in the amp dtype, and each launches its kernel."""
    from paddle_tpu_torch import amp
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    want = getattr(torch, dtype)
    q = torch.randn((2, 128, 4, 64), generator=gen, device="cuda")
    x = torch.randn((2, 64, 256), generator=gen, device="cuda")
    w = torch.randn((512, 256), generator=gen, device="cuda") / 16
    wr = torch.randn((256, 256), generator=gen, device="cuda") / 16
    counts = (FK.fused_matmul.launches, FK.fused_matmul_rope.launches,
              flash_attention_fwd.launches)
    with amp.auto_cast(level=level, dtype=dtype):
        out, _ = F.flash_attention(q, q, q, causal=True)
        y = F.fused_norm_linear(x, w, norm_weight=torch.ones(
            256, device="cuda"), norm_type="layer_norm")
        r = F.fused_rope_proj(x, wr, num_heads=2)
    torch.cuda.synchronize()
    assert (out.dtype, y.dtype, r.dtype) == (want,) * 3
    assert (FK.fused_matmul.launches, FK.fused_matmul_rope.launches,
            flash_attention_fwd.launches) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_fused_linear_cross_entropy_on_the_card(dtype):
    """The chunked loss on the card: its loss and gradients against the
    plain cross entropy on the full logits."""
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = torch.randn((300, 128), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((1000, 128), generator=gen, device="cuda")
         / 12).to(dtype)
    lab = torch.randint(0, 1000, (300,), generator=gen, device="cuda")
    lab[::7] = -100
    grads = []
    for fused in (True, False):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        loss = (F.fused_linear_cross_entropy(xl, wl, lab, transpose_y=True,
                                             chunk_rows=128) if fused else
                F.cross_entropy(torch.matmul(xl, wl.t()), lab))
        loss.backward()
        grads.append((loss.detach(), xl.grad.float(), wl.grad.float()))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(*grads):
        err = (got.float() - want.float()).norm() / want.float().norm()
        assert err.item() <= tol


@pytest.mark.cuda
def test_recompute_on_the_card_launches_k1_in_the_replay():
    """A recomputed LLaMA block launches K1 in the forward and again in
    the backward's replay; the gradients equal those without recompute."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    _card()
    cfg = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
               num_layers=2, num_heads=2, max_seq_len=128)
    grads, launches = [], []
    ids = torch.randint(0, 256, (2, 128), device="cuda")
    for on in (False, True):
        model = LlamaForCausalLM(LlamaConfig(**cfg, recompute=on),
                                 device="cuda", seed=6)
        before = flash_attention_fwd.launches
        _, loss = model(ids, labels=ids)
        loss.backward()
        torch.cuda.synchronize()
        launches.append(flash_attention_fwd.launches - before)
        grads.append([p.grad for p in model.parameters()])
    assert launches == [2, 4]
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("switches", [
    dict(), dict(kv_dtype="int8"), dict(speculate="ngram", speculate_k=3)],
    ids=["plain", "int8", "speculative"])
def test_llama_engine_on_the_card_matches_cpu_tensors(switches):
    """A tiny fp32 LLaMA engine (GQA) gives the same greedy tokens on the
    card as the same engine on CPU tensors, and the sampler's uniforms
    are the same numbers on both."""
    from paddle_tpu_torch.inference import LlamaPagedEngine
    from paddle_tpu_torch.inference.serving import _request_uniforms
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    _card()
    cfg = LlamaConfig(vocab_size=97, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      max_seq_len=256, use_flash_attention=False)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, 97, (n,), generator=gen).tolist() * 2
               for n in (5, 11, 3, 9)]
    outs = []
    for device in ("cuda", "cpu"):
        model = LlamaForCausalLM(cfg, device=device, seed=4).eval()
        eng = LlamaPagedEngine(model, max_batch=2, block_size=4,
                               num_blocks=48, max_blocks_per_seq=12,
                               device=device, **switches)
        rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        out = eng.run_to_completion()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]
    rids, ngens = torch.arange(1, 9), torch.arange(8) * 3
    assert torch.equal(_request_uniforms(5, rids.cuda(), ngens.cuda(),
                                         97).cpu(),
                       _request_uniforms(5, rids, ngens, 97))


@pytest.mark.cuda
@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_on_the_card(largest):
    """topk on a CUDA tensor: sorted, the lower index first among ties
    (lax.top_k's order), the same as on the CPU."""
    _card()
    import paddle_tpu_torch as paddle
    x = [[1, 3, 3, 2, 3, 0, 3], [2, 1, 1, 3, 1, 1, 2]]
    with paddle.device_guard("gpu"):
        v, i = paddle.topk(paddle.to_tensor(x, dtype="float32"), 3,
                           largest=largest, sorted=False)
        assert i._data.is_cuda
    with paddle.device_guard("cpu"):
        vc, ic = paddle.topk(paddle.to_tensor(x, dtype="float32"), 3,
                             largest=largest)
    assert i.numpy().tolist() == ic.numpy().tolist()
    assert v.numpy().tolist() == vc.numpy().tolist()
    expect = [[1, 2, 4], [3, 0, 6]] if largest else [[5, 0, 3], [1, 2, 4]]
    assert i.numpy().tolist() == expect


@pytest.mark.cuda
def test_conv_pool_and_prefetch_on_the_card():
    """Conv2D/MaxPool2D/AdaptiveAvgPool2D on CUDA tensors against CPU
    tensors (TF32 off), and a DevicePrefetcher batch read on the
    consumer's stream equal to its host batch."""
    _card()
    import numpy as np

    import paddle_tpu_torch as paddle
    torch.backends.cudnn.allow_tf32 = False
    x = np.random.RandomState(0).randn(2, 3, 17, 15).astype(np.float32)
    outs = []
    for dev in ("cpu", "gpu"):
        with paddle.device_guard(dev):
            paddle.seed(0)
            conv = paddle.nn.Conv2D(3, 8, 3, stride=2, padding=[1, 0, 2, 1])
            if dev == "gpu":
                conv.set_state_dict(ref_state)
            else:
                ref_state = {k: v.numpy() for k, v in
                             conv.state_dict().items()}
            y = conv(paddle.to_tensor(x))
            y = paddle.nn.functional.max_pool2d(y, 3, 2, 1, ceil_mode=True)
            y = paddle.nn.functional.avg_pool2d(y, 2, 2, ceil_mode=True,
                                                exclusive=False)
            outs.append(paddle.nn.functional.adaptive_avg_pool2d(
                y, [2, 3]).numpy())
    assert np.abs(outs[0] - outs[1]).max() <= 1e-4
    with paddle.device_guard("gpu"):
        batches = [(np.full((64, 64), i, np.float32),) for i in range(6)]
        pf = paddle.io.DevicePrefetcher(iter(batches), depth=2)
        for i, (b,) in enumerate(pf):
            assert b._data.is_cuda
            assert float(b._data.mean()) == float(i)
        assert i == 5 and pf.closed


@pytest.mark.cuda
def test_save_load_round_trips_cuda_tensors(tmp_path):
    """framework.io on the card: bf16, fp32 and int8 CUDA tensors (port
    Tensors and plain torch tensors, inline and >1 MB segments) come back
    bit for bit, on the card; the bf16 segments, in the layout the JAX
    package reads, load to the same bits on the CPU."""
    _card()
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.framework import io
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    state = {
        "bf16": torch.randn((3, 5), generator=gen,
                            device="cuda").to(torch.bfloat16),
        "bf16_big": torch.randn((1 << 20,), generator=gen,
                                device="cuda").to(torch.bfloat16),
        "fp32": tp.Tensor(torch.randn((4, 7), generator=gen,
                                      device="cuda")),
        "fp32_big": torch.randn((1 << 19,), generator=gen, device="cuda"),
        "int8": torch.randint(-128, 128, (33,), generator=gen,
                              device="cuda", dtype=torch.int8),
        "nested": {"step": 3, "list": [tp.Tensor(torch.ones(
            2, device="cuda", dtype=torch.bfloat16))]},
    }
    path = str(tmp_path / "card.pdckpt")
    io.save(state, path)

    def flat(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update({f"{k}.{j}": x for j, x in flat(v).items()})
            elif isinstance(v, list):
                out.update({f"{k}[{i}]": x for i, x in enumerate(v)})
            else:
                out[k] = v
        return out

    def payload(t):
        return t._data if isinstance(t, tp.Tensor) else t

    def bits(t):
        t = payload(t)
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    want = flat(state)
    with tp.device_guard("gpu:0"):
        got = flat(io.load(path))
    with tp.device_guard("cpu"):
        host = flat(io.load(path, verify=False))
    assert set(got) == set(want) == set(host)
    for k, v in want.items():
        if k.endswith("step"):
            assert got[k] == host[k] == v
            continue
        assert got[k]._data.is_cuda and got[k].dtype == payload(v).dtype, k
        assert torch.equal(bits(got[k]), bits(v)), k
        assert host[k]._data.device.type == "cpu", k
        assert torch.equal(bits(host[k]), bits(got[k]).cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k1_op_equals_the_direct_launch(dtype):
    """``paddle_tpu_torch::flash_attention_fwd`` on CUDA tensors is the
    launch itself (bit for bit), counted once."""
    _card()
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    q, k, v = (torch.randn((2, 200, 4, 64), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    before = flash_attention_fwd.launches
    out, lse = torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, k, v, True, 0.125)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = fa._fwd_cuda(q, k, v, True, 0.125)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


@pytest.mark.cuda
def test_k1_op_raises_where_the_kernel_does_not_run():
    """The op has no plain fallback on the card: head_dim 32 raises and
    launches nothing."""
    _card()
    x = torch.randn((1, 8, 2, 32), device="cuda")
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="head_dim"):
        torch.ops.paddle_tpu_torch.flash_attention_fwd(x, x, x, False, 0.1)
    assert flash_attention_fwd.launches == before


@pytest.mark.cuda
def test_translated_layer_launches_k1(tmp_path):
    """A tiny BERT saved on the CPU, loaded on the card, launches K1 once a
    layer and gives the CPU model's logits; the same model saved on the
    card and loaded under ``set_device("cpu")`` runs on the CPU."""
    _card()
    import numpy as np

    import paddle_tpu_torch as tp
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.static import InputSpec
    cfg = bert.BertConfig(vocab_size=100, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=256, max_position_embeddings=64,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 100, (3, 40)).astype(np.int64)
    tt = rng.randint(0, 2, (3, 40)).astype(np.int64)
    spec = [InputSpec([-1, -1], "int64")] * 2
    with tp.device_guard("cpu"):
        tp.seed(0)
        cpu_model = bert.BertForSequenceClassification(cfg)
        cpu_model.eval()
        want = cpu_model(tp.to_tensor(ids, dtype="int64"),
                         tp.to_tensor(tt, dtype="int64")).numpy()
        tp.jit.save(cpu_model, str(tmp_path / "cpu"), input_spec=spec)
        state = {k: v.numpy() for k, v in cpu_model.state_dict().items()}
    with tp.device_guard("gpu:0"):
        loaded = tp.jit.load(str(tmp_path / "cpu"))
        before = (flash_attention_fwd.launches,
                  flash_attention_bwd_dq.launches)
        got = loaded(tp.to_tensor(ids, dtype="int64"),
                     tp.to_tensor(tt, dtype="int64"))
        torch.cuda.synchronize()
        assert got._data.is_cuda
        assert (flash_attention_fwd.launches,
                flash_attention_bwd_dq.launches) == (before[0] + 2,
                                                     before[1])
        assert np.abs(got.numpy() - want).max() <= 1e-3
        card_model = bert.BertForSequenceClassification(cfg)
        card_model.set_state_dict(state)
        tp.jit.save(card_model, str(tmp_path / "card"), input_spec=spec)
    with tp.device_guard("cpu"):
        before = flash_attention_fwd.launches
        host = tp.jit.load(str(tmp_path / "card"))(
            tp.to_tensor(ids, dtype="int64"), tp.to_tensor(tt, dtype="int64"))
        assert host._data.device.type == "cpu"
        assert flash_attention_fwd.launches == before
        assert np.abs(host.numpy() - want).max() <= 1e-5
