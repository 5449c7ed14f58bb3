"""Flash-attention forward: the hand-written Hopper kernel, its wrapper and
its plain PyTorch version.

Counterpart of the forward half of ``paddle_tpu/ops/pallas/flash_attention.py``
(``flash_attention_fwd`` -> ``_flash_fwd_bhsd`` -> ``_fwd_kernel``). The
kernel is ``paddle_tpu_torch/csrc/flash_attention_fwd.cu``; its header
comment gives its bound and design.

``flash_attention_fwd`` takes BSHD tensors. On CPU tensors it runs
``flash_attention_fwd_plain``; on CUDA tensors it launches the kernel or
raises, and adds one to ``flash_attention_fwd.launches`` per launch.
The backward kernels (the TPU's ``_dq_kernel`` / ``_dkv_kernel``) belong
to the training slice; until then a CUDA input that requires grad raises.
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


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd: q, k and v must all be on "
                         "the CPU or all on a CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_fwd: q/k/v must share one of "
                        f"float32/bfloat16/float16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q/k/v must be (B, S, H, d)")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if s_q == 0 or k.shape[1] == 0 or b * h > 65535:
        raise ValueError(f"flash_attention_fwd: unsupported sizes "
                         f"B*H={b * h}, Sq={s_q}, Sk={k.shape[1]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        # the kernel reads rows of d values with 16-byte loads
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name}'s head dim must "
                             f"be contiguous (stride {x.stride()})")
        if (x.data_ptr() % 16
                or any(st * x.element_size() % 16 for st in x.stride()[:3])):
            raise ValueError(f"flash_attention_fwd: {name} rows must be "
                             f"16-byte aligned (strides {x.stride()})")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_attention_fwd: the backward kernels come with the "
            "training slice; call under torch.no_grad() or "
            "torch.inference_mode()")


def _library():
    lib = _build.load_library("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, d), k/v (B, Sk, H, d) -> (out (B, Sq, H, d), lse
    (B, H, Sq) fp32). CPU tensors run the plain version; CUDA tensors
    launch the kernel (d in {64, 128}, fp32/bf16/fp16) or raise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], b, h, s_q, s_k, d, _DTYPE_CODE[q.dtype],
                 float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed "
                           f"(cudaError {err})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
