"""Flash attention: the hand-written Hopper kernels, their wrappers, their
plain PyTorch versions and the autograd Function around them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:

* K1 ``flash_attention_fwd`` -> ``csrc/flash_attention_fwd.cu``
  (the TPU's ``_fwd_kernel``), reached through one ``torch.library``
  op, ``paddle_tpu_torch::flash_attention_fwd``, so that a graph that
  ``torch.export`` captures (``jit.save``) holds K1 as a node and not
  the plain version's einsums;
* K2 ``flash_attention_bwd_dq`` and K3 ``flash_attention_bwd_dkv`` ->
  ``csrc/flash_attention_bwd.cu`` (the TPU's ``_dq_kernel`` and
  ``_dkv_kernel``);
* ``FlashAttentionFunction``, the counterpart of the ``_flash_attention``
  custom_vjp: its forward is K1, its backward computes
  Delta = rowsum(dO * O) with one torch reduction (the JAX package does
  it outside any kernel too) and then launches K2 and K3.

Each wrapper takes BSHD tensors through their strides. On CPU tensors it
runs the plain version; on CUDA tensors it launches its kernel or raises,
and adds one to its ``.launches`` per launch. The sources' header
comments give each kernel's bound and design.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in fp32.

    q (B, Sq, H, d), k/v (B, Sk, H, d) -> (out (B, Sq, H, d) in q's dtype,
    lse (B, H, Sq) fp32). Causal is bottom-right aligned (query i sees
    keys <= i + Sk - Sq); rows that see no key give 0 out and an LSE of
    about -1e30, as in the TPU kernel.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(diagonal=t - s)
        logits = logits.masked_fill(~keep, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(m > NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    out = out / l.squeeze(-1).transpose(1, 2).unsqueeze(-1)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def _bwd_plain_from_delta(q, k, v, do, lse, delta, causal, scale):
    """dq, dk, dv (fp32) from the saved LSE and Delta = rowsum(dO * O),
    with the explicit FA2 formulas of the TPU kernels."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    s_q, s_k = s.shape[-2], s.shape[-1]
    if causal:
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
    else:
        keep = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    # the mask guard, not exp underflow, keeps P at 0: a row that sees no
    # key has an LSE of about -1e30 and exp(-1e30 - lse) would be 1
    p = torch.where(keep, torch.exp(s.masked_fill(~keep, NEG_INF)
                                    - lse.unsqueeze(-1)), 0.0)
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dq = torch.einsum("bhst,bthd->bshd", ds, kf)
    dk = torch.einsum("bhst,bshd->bthd", ds, qf)
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    return dq, dk, dv


def flash_attention_bwd_delta(out: torch.Tensor,
                              do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in fp32, (B, Sq, H, d) -> (B, H, Sq)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch, in fp32.

    q/out/do (B, Sq, H, d), k/v (B, Sk, H, d), lse (B, H, Sq) fp32 ->
    (dq, dk, dv) in the inputs' dtypes. Delta = rowsum(dO * O);
    P = exp(S * scale - lse) under the mask; dS = P * (dP - Delta) *
    scale; dQ = dS K, dK = dS^T Q, dV = P^T dO.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = flash_attention_bwd_delta(out, do)
    dq, dk, dv = _bwd_plain_from_delta(q, k, v, do, lse, delta, causal,
                                       scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, do=None):
    tensors = [("q", q), ("k", k), ("v", v)] + ([("do", do)] if do is not None
                                                else [])
    if not all(x.is_cuda for _, x in tensors):
        raise ValueError(f"{name}: q, k, v (and do) must all be on the CPU "
                         f"or all on a CUDA device")
    if len({x.device for _, x in tensors}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype
                                         for _, x in tensors):
        raise TypeError(f"{name}: inputs must share one of "
                        f"float32/bfloat16/float16, got "
                        f"{[str(x.dtype) for _, x in tensors]}")
    if any(x.dim() != 4 for _, x in tensors):
        raise ValueError(f"{name}: inputs must be (B, S, H, d)")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d) or (
            do is not None and do.shape != q.shape):
        raise ValueError(f"{name}: shapes "
                         f"{[tuple(x.shape) for _, x in tensors]} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if s_q == 0 or k.shape[1] == 0 or b * h > 65535:
        raise ValueError(f"{name}: unsupported sizes B*H={b * h}, "
                         f"Sq={s_q}, Sk={k.shape[1]}")
    for tag, x in tensors:
        if not _rows_aligned(x):
            raise ValueError(f"{name}: {tag} needs a contiguous head dim and "
                             f"16-byte aligned rows (strides {x.stride()})")


def _rows_aligned(x: torch.Tensor) -> bool:
    """The kernels read rows of d values with 16-byte loads."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and not any(st * x.element_size() % 16 for st in x.stride()[:3]))


def _check_rows(name, q, *rows):
    """lse / Delta: contiguous (B, H, Sq) fp32 on q's device."""
    b, s_q, h, _ = q.shape
    for x in rows:
        if (x.dtype != torch.float32 or x.device != q.device
                or tuple(x.shape) != (b, h, s_q) or not x.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"(B, H, Sq) = {(b, h, s_q)} float32 on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")


def _function(source: str, name: str, n_ptr: int, n_ll: int):
    """C function ``name`` of ``csrc/<source>.cu``: ``n_ptr`` pointers,
    ``n_ll`` strides, six ints, the scale, the causal flag, the stream."""
    fn = getattr(_build.load_library(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_ll
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(name, fn, q, *args):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


def _sizes(q, k):
    b, s_q, h, d = q.shape
    return b, h, s_q, k.shape[1], d, _DTYPE_CODE[q.dtype]


# K1 as one op that an exported graph holds as a node. It is declared
# with the low-level ``torch.library.Library`` (a CPU and a CUDA kernel
# and a fake one): ``torch.library.custom_op``'s Python wrapper added
# more host time a call than this declaration does (PERF.md, Findings).
# It has no autograd kernel: a call that trains goes through
# ``FlashAttentionFunction``, whose forward runs it without grad.
_LIB = torch.library.Library("paddle_tpu_torch", "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale) -> (Tensor, Tensor)")


def _fwd_cpu(q, k, v, causal, scale):
    """The op on CPU tensors: the plain version."""
    return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)


def _fwd_cuda(q, k, v, causal, scale):
    """The op on CUDA tensors: the launch, or a raise; it counts on
    ``flash_attention_fwd.launches``."""
    name = "flash_attention_fwd"
    _check(name, q, k, v)
    b, s_q, h, d = q.shape
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    _launch(name, _function("flash_attention_fwd", name, 5, 9), q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *_sizes(q, k), float(scale), int(bool(causal)))
    flash_attention_fwd.launches += 1
    return out, lse


def _fwd_fake(q, k, v, causal, scale):
    """The shapes ``torch.export`` traces with (no storage to launch on)."""
    b, s_q, h, d = q.shape
    return (q.new_empty((b, s_q, h, d)),
            q.new_empty((b, h, s_q), dtype=torch.float32))


_LIB.impl("flash_attention_fwd", _fwd_cpu, "CPU")
_LIB.impl("flash_attention_fwd", _fwd_cuda, "CUDA")
torch.library.register_fake("paddle_tpu_torch::flash_attention_fwd",
                            _fwd_fake, lib=_LIB)
_fwd_op = torch.ops.paddle_tpu_torch.flash_attention_fwd.default


def _fwd(q, k, v, causal, scale):
    """K1 outside autograd: the ``paddle_tpu_torch::flash_attention_fwd``
    op (its launches count on ``flash_attention_fwd``)."""
    return _fwd_op(q, k, v, bool(causal), float(scale))


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """K2: dQ (B, Sq, H, d), contiguous, in q's dtype. q/do (B, Sq, H, d)
    and k/v (B, Sk, H, d) are read through their strides; lse and delta
    are (B, H, Sq) fp32. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not (q.is_cuda or k.is_cuda or v.is_cuda or do.is_cuda):
        dq, _, _ = _bwd_plain_from_delta(q, k, v, do, lse, delta, causal,
                                         scale)
        return dq.to(q.dtype)
    name = "flash_attention_bwd_dq"
    _check(name, q, k, v, do)
    _check_rows(name, q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(name, _function("flash_attention_bwd", name, 7, 12), q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *_sizes(q, k), float(scale), int(bool(causal)))
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dK, dV), each (B, Sk, H, d), contiguous, in k's dtype; the
    inputs as for ``flash_attention_bwd_dq``. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not (q.is_cuda or k.is_cuda or v.is_cuda or do.is_cuda):
        _, dk, dv = _bwd_plain_from_delta(q, k, v, do, lse, delta, causal,
                                          scale)
        return dk.to(k.dtype), dv.to(v.dtype)
    name = "flash_attention_bwd_dkv"
    _check(name, q, k, v, do)
    _check_rows(name, q, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(name, _function("flash_attention_bwd", name, 8, 12), q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *_sizes(q, k), float(scale), int(bool(causal)))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Counterpart of the ``_flash_attention`` custom_vjp: K1 forward,
    saving (q, k, v, out, lse); the backward computes Delta and launches
    K2 and K3 (on CPU tensors: the plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if not _rows_aligned(dout):       # e.g. the stride-0 grad of sum()
            dout = dout.contiguous()
        delta = flash_attention_bwd_delta(out, dout)
        if not q.is_cuda:             # one plain backward gives all three
            dq, dk, dv = _bwd_plain_from_delta(q, k, v, dout, lse, delta,
                                               ctx.causal, ctx.scale)
            return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                    None)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                    causal=ctx.causal, scale=ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, d), k/v (B, Sk, H, d) -> (out (B, Sq, H, d), lse
    (B, H, Sq) fp32), the counterpart of the JAX ``flash_attention_fwd``.

    When grad is enabled and an input requires it, the call goes through
    ``FlashAttentionFunction`` (K1 now, K2 and K3 on backward); otherwise
    it is K1 alone. CPU tensors run the plain versions; CUDA tensors
    launch the kernels (d in {64, 128}, fp32/bf16/fp16) or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                            float(scale))
    return _fwd(q, k, v, causal, scale)


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
