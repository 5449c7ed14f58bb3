"""The fused kernels behind the graph-fusion pass: the hand-written Hopper
kernels K4-K7, their wrappers and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/fused_ops.py``:

* K4 ``fused_residual_norm`` -> ``csrc/fused_residual_norm.cu`` (the TPU's
  ``_norm_kernel``): ``s = x + res``; ``y = norm(s) * w + b``; returns
  ``(y, s)``;
* K5 ``fused_bias_act`` -> ``csrc/fused_bias_act.cu`` (``_bias_act_kernel``):
  ``act(x + b)``;
* K6 ``fused_matmul`` -> ``csrc/fused_matmul.cu`` (``_matmul_kernel``):
  ``act(norm(x) W^T + b)``; in bf16/fp16 the norm is K6's row pass
  (``fused_norm_rows``, reachable on its own) into a buffer of x's type,
  launched by the same call before the product;
* K7 ``fused_matmul_rope`` -> ``csrc/fused_matmul.cu`` (``_matmul_rope_kernel``):
  ``rope(x W^T + b)`` over the flattened (batch, seq) rows.

Each wrapper takes 2-D rows as the TPU wrappers do. Weights are in
torch's ``nn.Linear`` layout, W (N, K), and the kernels read them as
``x W^T``. All statistics, sums, biases, activations and rotations are
fp32; each output is rounded once to x's type. On CPU tensors a wrapper
runs its plain version; on CUDA tensors it launches its kernel or raises,
and adds one to its ``.launches`` per launch. There is no shape gate and
no autotuner: the JAX package's are TPU measurements. The sources' header
comments give each kernel's bound and design.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.nn import functional as TF

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
NORM_CODE = {"": 0, "layer_norm": 1, "rms_norm": 2}
ACT_CODE = {"": 0, "none": 0, None: 0, "gelu": 1, "gelu_tanh": 2, "silu": 3,
            "relu": 4}
MAX_NORM_DIM = 32768      # K4 keeps a row's fp32 sum in shared memory


def act_apply(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The fused activation vocabulary (counterpart of ``_act_apply``):
    gelu (erf), gelu_tanh, silu, relu, or none."""
    if act == "gelu":
        return TF.gelu(y)
    if act == "gelu_tanh":
        return TF.gelu(y, approximate="tanh")
    if act == "silu":
        return TF.silu(y)
    if act == "relu":
        return torch.relu(y)
    if act in ("", "none", None):
        return y
    raise ValueError(f"unknown fused activation {act!r}")


def normalize_rows(x32: torch.Tensor, w32: Optional[torch.Tensor],
                   b32: Optional[torch.Tensor], kind: str,
                   eps: float) -> torch.Tensor:
    """Row-wise LayerNorm/RMSNorm over the last dim in fp32, the sequence
    of ``_normalize_rows``: LayerNorm takes the mean, the centered values,
    their mean square and rsqrt(var + eps); RMSNorm the mean of x² and
    x * rsqrt(ms + eps). Then ``* w + b``; a missing weight is 1, a missing
    bias 0. K4 and K6 take these fp32 statistics."""
    if kind not in ("layer_norm", "rms_norm"):
        raise ValueError(f"unknown norm kind {kind!r}")
    centered = x32
    if kind == "layer_norm":
        centered = x32 - x32.mean(dim=-1, keepdim=True)
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    if w32 is not None:
        y = y * w32
    if b32 is not None:
        y = y + b32
    return y


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


# ------------------------------------------------------- plain versions
def fused_residual_norm_plain(x: torch.Tensor, res: torch.Tensor,
                              weight: Optional[torch.Tensor] = None,
                              bias: Optional[torch.Tensor] = None,
                              kind: str = "layer_norm", eps: float = 1e-5
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain PyTorch: the fp32 sum is normalized (not the
    sum rounded to x's type) and stored rounded; returns (y, s)."""
    s32 = x.float() + res.float()
    y = normalize_rows(s32, _f32(weight), _f32(bias), kind, eps)
    return y.to(x.dtype), s32.to(x.dtype)


def fused_bias_act_plain(x: torch.Tensor, bias: torch.Tensor,
                         act: str = "gelu") -> torch.Tensor:
    """K5's function in plain PyTorch: act(x + b) in fp32, rounded once."""
    return act_apply(x.float() + bias.float(), act).to(x.dtype)


def fused_norm_rows_plain(x: torch.Tensor,
                          norm_weight: Optional[torch.Tensor] = None,
                          norm_bias: Optional[torch.Tensor] = None,
                          kind: str = "layer_norm",
                          eps: float = 1e-5) -> torch.Tensor:
    """K6's row pass in plain PyTorch: norm(x) * w + b over x (M, K) with
    fp32 statistics, rounded to x's type."""
    return normalize_rows(x.float(), _f32(norm_weight), _f32(norm_bias), kind,
                          eps).to(x.dtype)


def fused_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       norm_weight: Optional[torch.Tensor] = None,
                       norm_bias: Optional[torch.Tensor] = None,
                       norm_kind: str = "", act: str = "",
                       eps: float = 1e-5) -> torch.Tensor:
    """K6's function in plain PyTorch: x (M, K), w (N, K). The norm takes
    fp32 statistics, and the normalized rows are rounded to x's type
    before the fp32 product (``fused_norm_rows_plain``), as the TPU kernel
    rounds them; bias and activation in fp32, rounded once."""
    xn = x
    if norm_kind:
        xn = fused_norm_rows_plain(x, norm_weight, norm_bias, norm_kind, eps)
    acc = xn.float() @ w.float().t()
    if bias is not None:
        acc = acc + bias.float()
    return act_apply(acc, act).to(x.dtype)


def fused_matmul_rope_plain(x: torch.Tensor, w: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            seq: int, head_dim: int, theta: float = 10000.0,
                            pos_offset: int = 0) -> torch.Tensor:
    """K7's function in plain PyTorch: x (B*S, K), w (H*hd, K); the fp32
    product (+ bias) is rotated within each head (rotate-half: column i
    with column i + hd/2) in fp32 and rounded once. Row r sits at position
    r % seq + pos_offset, and freq_i = 1 / theta^(i / (hd/2))."""
    acc = x.float() @ w.float().t()
    if bias is not None:
        acc = acc + bias.float()
    m, n = acc.shape
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    pos = (torch.arange(m, device=x.device) % seq).float() + float(pos_offset)
    angle = pos[:, None] * freqs[None, :]
    cos, sin = torch.cos(angle)[:, None, :], torch.sin(angle)[:, None, :]
    a = acc.view(m, n // head_dim, head_dim)
    x1, x2 = a[..., :half], a[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(m, n).to(x.dtype)


# ------------------------------------------------------------- wrappers
def _check(name: str, x: torch.Tensor, *others: Optional[torch.Tensor]):
    """CUDA inputs: one device, one of fp32/bf16/fp16, contiguous, 16-byte
    aligned (the kernels read 16 bytes at once)."""
    tensors = [x] + [t for t in others if t is not None]
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs must all be on the CPU or all on "
                         f"one CUDA device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{name}: inputs must share one of float32/bfloat16/"
                        f"float16, got {[str(t.dtype) for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             f"aligned (shape {tuple(t.shape)}, strides "
                             f"{t.stride()})")


def _check_vec(name: str, t: Optional[torch.Tensor], n: int, what: str):
    if t is not None and tuple(t.shape) != (n,):
        raise ValueError(f"{name}: {what} must be ({n},), got {tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _function(source: str, name: str, argtypes):
    fn = getattr(_build.load_library(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _launch(name: str, fn, x: torch.Tensor, *args):
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def fused_residual_norm(x: torch.Tensor, res: torch.Tensor,
                        weight: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        kind: str = "layer_norm", eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: x, res (R, D) -> (y, s), both (R, D) in x's type; weight and bias
    (D,) or None. CPU tensors run the plain version; CUDA tensors launch
    the kernel (D <= 32768) or raise."""
    if not x.is_cuda:
        return fused_residual_norm_plain(x, res, weight, bias, kind, eps)
    name = "fused_residual_norm"
    _check(name, x, res, weight, bias)
    if x.dim() != 2 or res.shape != x.shape or kind not in ("layer_norm",
                                                            "rms_norm"):
        raise ValueError(f"{name}: x and res must be one (R, D) shape and "
                         f"kind layer_norm or rms_norm")
    r, d = x.shape
    _check_vec(name, weight, d, "weight")
    _check_vec(name, bias, d, "bias")
    if r == 0 or not 0 < d <= MAX_NORM_DIM:
        raise ValueError(f"{name}: unsupported sizes R={r}, D={d}")
    y, s = torch.empty_like(x), torch.empty_like(x)
    fn = _function(name, name, [_P] * 6 + [_I] * 4 + [_F, _P])
    _launch(name, fn, x, x.data_ptr(), res.data_ptr(), _ptr(weight),
            _ptr(bias), y.data_ptr(), s.data_ptr(), r, d, _DTYPE_CODE[x.dtype],
            NORM_CODE[kind], float(eps))
    fused_residual_norm.launches += 1
    return y, s


def fused_bias_act(x: torch.Tensor, bias: torch.Tensor,
                   act: str = "gelu") -> torch.Tensor:
    """K5: act(x + b) over x (R, D), b (D,), in x's type. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return fused_bias_act_plain(x, bias, act)
    name = "fused_bias_act"
    _check(name, x, bias)
    if x.dim() != 2 or act not in ACT_CODE:
        raise ValueError(f"{name}: x must be (R, D) and act one of "
                         f"{sorted(k for k in ACT_CODE if k)}")
    r, d = x.shape
    _check_vec(name, bias, d, "bias")
    if r * d == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    y = torch.empty_like(x)
    fn = _function(name, name, [_P] * 3 + [_LL] + [_I] * 3 + [_P])
    _launch(name, fn, x, x.data_ptr(), bias.data_ptr(), y.data_ptr(), r, d,
            _DTYPE_CODE[x.dtype], ACT_CODE[act])
    fused_bias_act.launches += 1
    return y


def _check_matmul(name, x, w, bias):
    _check(name, x, w, bias)
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: x must be (M, K) and w (N, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[0]
    if k % 8 or m * n * k == 0 or (m + 63) // 64 > 65535:
        raise ValueError(f"{name}: unsupported sizes M={m}, N={n}, K={k} "
                         f"(K must be a multiple of 8)")
    _check_vec(name, bias, n, "bias")
    return m, n, k


def _norm_rows_into(name, out, x, norm_weight, norm_bias, kind, eps):
    """Launch K6's row pass on checked inputs, x (M, K), into ``out``."""
    fn = _function("fused_matmul", "fused_norm_rows",
                   [_P] * 4 + [_I] * 4 + [_F, _P])
    _launch(name, fn, x, x.data_ptr(), _ptr(norm_weight), _ptr(norm_bias),
            out.data_ptr(), x.shape[0], x.shape[1], _DTYPE_CODE[x.dtype],
            NORM_CODE[kind], float(eps))


def fused_norm_rows(x: torch.Tensor, norm_weight: Optional[torch.Tensor] = None,
                    norm_bias: Optional[torch.Tensor] = None,
                    kind: str = "layer_norm", eps: float = 1e-5
                    ) -> torch.Tensor:
    """K6's row pass on its own: norm(x) * w + b over x (M, K) with fp32
    statistics, rounded to x's type; what the bf16/fp16 K6 multiplies. CPU
    tensors run the plain version; CUDA tensors launch the kernel (bf16 or
    fp16, K a multiple of 8) or raise."""
    if not x.is_cuda:
        return fused_norm_rows_plain(x, norm_weight, norm_bias, kind, eps)
    name = "fused_norm_rows"
    if kind not in ("layer_norm", "rms_norm"):
        raise ValueError(f"{name}: kind must be layer_norm or rms_norm, got "
                         f"{kind!r}")
    _check(name, x, norm_weight, norm_bias)
    if x.dtype == torch.float32:
        raise TypeError(f"{name}: takes bfloat16 or float16 (the fp32 K6 "
                        f"normalizes inside its product)")
    if x.dim() != 2 or x.shape[1] % 8 or x.numel() == 0:
        raise ValueError(f"{name}: x must be (M, K) with K a multiple of 8, "
                         f"got {tuple(x.shape)}")
    _check_vec(name, norm_weight, x.shape[1], "norm_weight")
    _check_vec(name, norm_bias, x.shape[1], "norm_bias")
    out = torch.empty_like(x)
    _norm_rows_into(name, out, x, norm_weight, norm_bias, kind, eps)
    fused_norm_rows.launches += 1
    return out


def fused_matmul(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 norm_weight: Optional[torch.Tensor] = None,
                 norm_bias: Optional[torch.Tensor] = None,
                 norm_kind: str = "", act: str = "",
                 eps: float = 1e-5) -> torch.Tensor:
    """K6: act(norm(x) w^T + b) over x (M, K), w (N, K) -> (M, N) in x's
    type; ``norm_kind`` "" skips the norm. CPU tensors run the plain
    version; CUDA tensors launch the kernel (K a multiple of 8) or raise.
    One call counts one launch: in bf16/fp16 with a norm it runs the row
    pass into a buffer of x's type and then the product on those rows."""
    if not x.is_cuda:
        return fused_matmul_plain(x, w, bias, norm_weight, norm_bias,
                                  norm_kind, act, eps)
    name = "fused_matmul"
    if norm_kind not in NORM_CODE or act not in ACT_CODE:
        raise ValueError(f"{name}: unknown norm {norm_kind!r} or act {act!r}")
    m, n, k = _check_matmul(name, x, w, bias)
    _check(name, x, norm_weight, norm_bias)
    _check_vec(name, norm_weight, k, "norm_weight")
    _check_vec(name, norm_bias, k, "norm_bias")
    if norm_kind and x.dtype != torch.float32:
        # the fp32 body normalizes its tiles itself; bf16/fp16 multiply
        # the row pass's rows
        xn = torch.empty_like(x)
        _norm_rows_into(name, xn, x, norm_weight, norm_bias, norm_kind, eps)
        x, norm_kind = xn, ""
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = _function("fused_matmul", name, [_P] * 6 + [_I] * 6 + [_F, _P])
    _launch(name, fn, x, x.data_ptr(), w.data_ptr(), _ptr(bias),
            _ptr(norm_weight), _ptr(norm_bias), out.data_ptr(), m, n, k,
            _DTYPE_CODE[x.dtype], NORM_CODE[norm_kind], ACT_CODE[act],
            float(eps))
    fused_matmul.launches += 1
    return out


def fused_matmul_rope(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *, seq: int,
                      head_dim: int, theta: float = 10000.0,
                      pos_offset: int = 0) -> torch.Tensor:
    """K7: rope(x w^T + b) over x (B*S, K), w (H*hd, K) -> (B*S, H*hd) in
    x's type; row r sits at position r % seq + pos_offset. CPU tensors run
    the plain version; CUDA tensors launch the kernel (K a multiple of 8,
    head_dim in 16/32/64/128) or raise."""
    if not x.is_cuda:
        return fused_matmul_rope_plain(x, w, bias, seq=seq, head_dim=head_dim,
                                       theta=theta, pos_offset=pos_offset)
    name = "fused_matmul_rope"
    m, n, k = _check_matmul(name, x, w, bias)
    if head_dim not in (16, 32, 64, 128) or n % head_dim or seq <= 0:
        raise ValueError(f"{name}: head_dim {head_dim} must be 16, 32, 64 or "
                         f"128 and divide N={n}; seq={seq}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = _function("fused_matmul", name, [_P] * 4 + [_I] * 6 + [_F, _I, _P])
    _launch(name, fn, x, x.data_ptr(), w.data_ptr(), _ptr(bias),
            out.data_ptr(), m, n, k, _DTYPE_CODE[x.dtype], int(seq),
            int(head_dim), float(theta), int(pos_offset))
    fused_matmul_rope.launches += 1
    return out


fused_residual_norm.launches = 0
fused_bias_act.launches = 0
fused_norm_rows.launches = 0
fused_matmul.launches = 0
fused_matmul_rope.launches = 0
