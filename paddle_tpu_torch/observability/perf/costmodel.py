"""Analytical per-op cost model: FLOPs and HBM bytes per op class
(counterpart of ``paddle_tpu/observability/perf/costmodel.py``).

Each op class gets a closed-form FLOPs/bytes formula (matmul, conv,
attention, elementwise, reduction, norm, collectives), attached to the op
registry through ``OpDef.cost_fn`` so that the dispatcher, the profiler
and ``tools/perf_report.py`` read the same numbers. ``counted_cost`` is
the port's counterpart of the JAX package's ``xla_cost``: it runs a
function under ``torch.utils.flop_counter.FlopCounterMode`` and counts
the bytes each aten op reads and writes, so a test or the card check can
hold the model against a measured count.

Conventions (the JAX package's):

* ``flops`` counts a multiply-add as 2;
* ``bytes_read``/``bytes_written`` are the op's minimal HBM traffic: each
  input read once, each output written once;
* a cost_fn is ``fn(input_shapes, input_dtypes, attrs, output_shapes) ->
  OpCost``; shapes are tuples of ints, dtypes torch or numpy dtypes.

Where the port's formula differs from the JAX package's it is because
the JAX one does not price what the op computes, which the card check
(``chip_smoke.py`` phase ``perf``) showed:

* ``attention_cost`` counts only the visible (query, key) pairs when the
  attrs say ``causal``/``is_causal`` (the kernels skip masked tiles);
  without the attr it is the JAX formula;
* ``fused_linear_cross_entropy`` prices its ``x @ W`` projection over the
  vocabulary (the JAX table gives it the cross-entropy formula over ``x``
  alone, a fifth of a BERT-base step's FLOPs);
* ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` (K2 and K3,
  no registry op) have formulas of their own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["OpCost", "cost_of", "attach_cost_models", "counted_cost",
           "collective_cost", "einsum_cost", "dtype_bytes", "COST_MODELS",
           "relative_error", "roofline_bound"]


def dtype_bytes(dtype) -> int:
    """Element size in bytes of a torch or numpy dtype (bfloat16 is 2)."""
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return int(getattr(torch, dtype).itemsize)
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        # a scalar type object (ml_dtypes' bfloat16) or an array's dtype
        inner = getattr(dtype, "dtype", "float32")
        if isinstance(inner, torch.dtype):
            return int(inner.itemsize)
        return int(np.dtype(inner).itemsize)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@dataclass
class OpCost:
    """Modeled cost of one op execution."""

    flops: float = 0.0
    bytes_read: float = 0.0
    bytes_written: float = 0.0
    notes: str = ""

    @property
    def bytes(self) -> float:
        return self.bytes_read + self.bytes_written

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per HBM byte: the roofline's x-axis."""
        return self.flops / self.bytes if self.bytes else 0.0

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops,
                      self.bytes_read + other.bytes_read,
                      self.bytes_written + other.bytes_written,
                      self.notes or other.notes)

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "bytes": self.bytes,
                "arithmetic_intensity": round(self.arithmetic_intensity,
                                              4)}


def _io_bytes(input_shapes, input_dtypes, output_shapes,
              out_dtype=None) -> tuple:
    """Default traffic model: every input read once, every output written
    once (in the first input's dtype)."""
    read = 0.0
    for i, s in enumerate(input_shapes):
        db = dtype_bytes(input_dtypes[i]) if i < len(input_dtypes) else 4
        read += _numel(s) * db
    if out_dtype is None:
        out_dtype = input_dtypes[0] if input_dtypes else np.float32
    written = sum(_numel(s) * dtype_bytes(out_dtype)
                  for s in output_shapes)
    return read, written


# --------------------------------------------------------------------------
# Op-class formulas
# --------------------------------------------------------------------------
def matmul_cost(input_shapes, input_dtypes, attrs, output_shapes) -> OpCost:
    """(…, m, k) @ (…, k, n): 2·m·k·n per batch element. Handles the
    transpose_x/y attrs and broadcast batching (bmm/addmm/linear ride the
    same formula; a bias adds m·n)."""
    a, b = tuple(input_shapes[0]), tuple(input_shapes[1])
    attrs = attrs or {}
    if attrs.get("transpose_x") or attrs.get("transpose_X"):
        a = a[:-2] + (a[-1], a[-2])
    if attrs.get("transpose_y") or attrs.get("transpose_Y"):
        b = b[:-2] + (b[-1], b[-2])
    if len(a) == 1:
        a = (1, a[0])
    if len(b) == 1:
        b = (b[0], 1)
    m, k = int(a[-2]), int(a[-1])
    n = int(b[-1])
    batch = 1
    for d in (output_shapes[0][:-2] if output_shapes
              else np.broadcast_shapes(a[:-2], b[:-2])):
        batch *= int(d)
    flops = 2.0 * batch * m * k * n
    if len(input_shapes) > 2:          # bias (linear/addmm)
        flops += batch * m * n
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(flops, read, written, "matmul")


def conv2d_cost(input_shapes, input_dtypes, attrs,
                output_shapes) -> OpCost:
    """NCHW x (Cout, Cin/g, kh, kw): 2·N·Cout·Hout·Wout·(Cin/g)·kh·kw."""
    x, w = tuple(input_shapes[0]), tuple(input_shapes[1])
    attrs = attrs or {}
    groups = int(attrs.get("groups", 1) or 1)
    cout, cin_g = int(w[0]), int(w[1])
    kh = int(w[2]) if len(w) > 2 else 1
    kw = int(w[3]) if len(w) > 3 else 1
    if output_shapes:
        out = tuple(output_shapes[0])
        n = int(out[0])
        spatial = _numel(out[2:])
    else:
        n = int(x[0])
        stride = attrs.get("stride", 1)
        if isinstance(stride, (tuple, list)):
            stride = stride[0]
        stride = int(stride or 1)
        spatial = max(_numel(x[2:]) // (stride * stride), 1)
    flops = 2.0 * n * cout * spatial * cin_g * kh * kw
    if len(input_shapes) > 2:
        flops += n * cout * spatial      # bias
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(flops, read, written, f"conv groups={groups}")


def causal_pairs(s_q: int, s_kv: int) -> int:
    """(query, key) pairs of a bottom-right aligned causal mask: query i
    sees keys <= i + s_kv - s_q."""
    first = max(0, s_q - s_kv - 1)          # rows before it see no key
    rows = s_q - first
    return rows * (first + s_kv - s_q + 1 + s_kv) // 2


def _pairs(s_q, s_kv, attrs) -> int:
    attrs = attrs or {}
    if attrs.get("causal") or attrs.get("is_causal"):
        return causal_pairs(s_q, s_kv)
    return s_q * s_kv


def _bshd(input_shapes):
    q = tuple(input_shapes[0])
    k = tuple(input_shapes[1]) if len(input_shapes) > 1 else q
    if len(q) == 4:                       # (B, S, H, D)
        b, s_q, h, d = (int(x) for x in q)
        s_kv = int(k[1])
    else:                                 # (B, S, D) single head
        b, s_q, d = (int(x) for x in q)
        h, s_kv = 1, int(k[1])
    return b, s_q, s_kv, h, d


def attention_cost(input_shapes, input_dtypes, attrs,
                   output_shapes) -> OpCost:
    """Scaled-dot-product / flash attention over (B, S, H, D) q/k/v: QKᵀ
    and PV are 2·B·H·pairs·D FLOPs each, plus the softmax's ~5·B·H·pairs
    elementwise FLOPs, where pairs is S·S_kv, or the visible pairs under
    a ``causal``/``is_causal`` attr. Bytes follow the flash traffic model:
    q/k/v in, out out, no S×S matrix round trip."""
    b, s_q, s_kv, h, d = _bshd(input_shapes)
    pairs = _pairs(s_q, s_kv, attrs)
    mm = 4.0 * b * h * pairs * d
    soft = 5.0 * b * h * pairs
    read, written = _io_bytes(input_shapes[:3], input_dtypes,
                              output_shapes)
    return OpCost(mm + soft, read, written, "attention(flash traffic)")


def _attention_bwd_cost(products: int, outputs: int, note: str) -> Callable:
    def fn(input_shapes, input_dtypes, attrs, output_shapes) -> OpCost:
        """(q, k, v, dO) (B, S, H, D) and the (B, H, S) fp32 LSE and Delta
        in; ``products`` D-long products a visible pair; ``outputs``
        gradients of q's size out."""
        b, s_q, s_kv, h, d = _bshd(input_shapes)
        pairs = _pairs(s_q, s_kv, attrs)
        read, _ = _io_bytes(input_shapes, input_dtypes, ())
        item = dtype_bytes(input_dtypes[0]) if input_dtypes else 4
        written = outputs * b * s_q * h * d * item
        return OpCost(2.0 * products * b * h * pairs * d, read, written,
                      note)
    return fn


#: K2: S = QKᵀ, dP = dO Vᵀ, dQ = dS K (3 products a pair); dQ out
flash_attention_bwd_dq_cost = _attention_bwd_cost(3, 1, "attention dq")
#: K3: S, dP, dV = Pᵀ dO, dK = dSᵀ Q (4 products a pair); dK, dV out
flash_attention_bwd_dkv_cost = _attention_bwd_cost(4, 2, "attention dk dv")


def elementwise_cost(flops_per_elt: float = 1.0) -> Callable:
    def fn(input_shapes, input_dtypes, attrs, output_shapes) -> OpCost:
        n = _numel(output_shapes[0]) if output_shapes else (
            max((_numel(s) for s in input_shapes), default=0))
        read, written = _io_bytes(input_shapes, input_dtypes,
                                  output_shapes)
        return OpCost(flops_per_elt * n, read, written, "elementwise")
    return fn


def reduction_cost(input_shapes, input_dtypes, attrs,
                   output_shapes) -> OpCost:
    n = max((_numel(s) for s in input_shapes), default=0)
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(float(n), read, written, "reduction")


def norm_cost(input_shapes, input_dtypes, attrs, output_shapes) -> OpCost:
    """layer/rms/batch/group/instance norm: mean + var (2 passes) +
    normalize + affine ≈ 8 FLOPs an element of the activation."""
    n = _numel(input_shapes[0]) if input_shapes else 0
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(8.0 * n, read, written, "norm")


def softmax_cost(input_shapes, input_dtypes, attrs,
                 output_shapes) -> OpCost:
    n = _numel(input_shapes[0]) if input_shapes else 0
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(5.0 * n, read, written, "softmax")  # max,sub,exp,sum,div


def gather_cost(input_shapes, input_dtypes, attrs, output_shapes) -> OpCost:
    """embedding/gather: no FLOPs; traffic = the gathered rows + the
    indices."""
    read = 0.0
    if len(input_shapes) > 1:
        read += _numel(input_shapes[1]) * 8          # indices (i64)
    out_b = sum(_numel(s) * dtype_bytes(
        input_dtypes[0] if input_dtypes else np.float32)
        for s in output_shapes)
    return OpCost(0.0, read + out_b, out_b, "gather")


def embedding_bag_cost(input_shapes, input_dtypes, attrs,
                       output_shapes) -> OpCost:
    """Pooled gather (ids (…, L) x table (V, H) -> (…, H)): every id
    reads one H-row, the pool adds them (1 FLOP a gathered element), one
    pooled row is written a bag."""
    ids_n = _numel(input_shapes[0]) if input_shapes else 0
    table = tuple(input_shapes[1]) if len(input_shapes) > 1 else ()
    h = int(table[-1]) if table else 1
    item = dtype_bytes(input_dtypes[1]) if len(input_dtypes) > 1 else 4
    read = ids_n * 8 + ids_n * h * item      # indices (i64) + rows
    out_b = sum(_numel(s) * item for s in output_shapes)
    return OpCost(float(ids_n * h), read, out_b, "embedding_bag")


def scatter_add_cost(input_shapes, input_dtypes, attrs,
                     output_shapes) -> OpCost:
    """Row accumulate (dest (V, …) += updates at index): dest read and
    written once, updates and indices read once, one add an updated
    element."""
    upd_n = _numel(input_shapes[2]) if len(input_shapes) > 2 else 0
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(float(upd_n), read, written, "scatter_add")


def cross_entropy_cost(input_shapes, input_dtypes, attrs,
                       output_shapes) -> OpCost:
    n = _numel(input_shapes[0]) if input_shapes else 0
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(6.0 * n, read, written, "softmax+nll")


def linear_cross_entropy_cost(input_shapes, input_dtypes, attrs,
                              output_shapes) -> OpCost:
    """x (N, H) @ W, W (H, V) or (V, H), (+ bias), then the softmax + nll
    over the (N, V) logits, which never reach HBM: 2·N·H·V (+ N·V) +
    6·N·V FLOPs; x, W, the labels (and bias) in, the loss out."""
    x = tuple(input_shapes[0])
    w = tuple(input_shapes[1])
    h = int(x[-1])
    n = _numel(x[:-1])
    v = int(w[1]) if int(w[0]) == h else int(w[0])
    flops = 2.0 * n * h * v + 6.0 * n * v
    if len(input_shapes) > 3:          # bias
        flops += n * v
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(flops, read, written, "linear+softmax+nll")


def fused_residual_norm_cost(input_shapes, input_dtypes, attrs,
                             output_shapes) -> OpCost:
    """residual add (1) + norm (~8) FLOPs an element; traffic = x +
    residual in, normed + sum out."""
    n = _numel(input_shapes[0]) if input_shapes else 0
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(9.0 * n, read, written, "fused residual+norm")


def fused_norm_linear_cost(input_shapes, input_dtypes, attrs,
                           output_shapes) -> OpCost:
    """norm prologue (~8 an element of x) + GEMM + bias/act epilogue (~5
    an element of out); traffic = x + W (+ vectors) in, one output out."""
    mm = matmul_cost(input_shapes[:2] if len(input_shapes) >= 2
                     else input_shapes, input_dtypes, {}, output_shapes)
    n_in = _numel(input_shapes[0]) if input_shapes else 0
    n_out = _numel(output_shapes[0]) if output_shapes else 0
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(mm.flops + 8.0 * n_in + 5.0 * n_out, read, written,
                  "fused norm+linear+act")


def fused_rope_proj_cost(input_shapes, input_dtypes, attrs,
                         output_shapes) -> OpCost:
    """GEMM + rotary epilogue (~6 FLOPs an output element)."""
    mm = matmul_cost(input_shapes[:2] if len(input_shapes) >= 2
                     else input_shapes, input_dtypes, {}, output_shapes)
    n_out = _numel(output_shapes[0]) if output_shapes else 0
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(mm.flops + 6.0 * n_out, read, written,
                  "fused rope projection")


def einsum_cost(input_shapes, input_dtypes, attrs, output_shapes) -> OpCost:
    """General einsum from the recorded ``equation`` attr: FLOPs = 2 x the
    product of every distinct label's extent. Without an equation, the
    matmul formula when the shapes allow it, else elementwise over the
    largest operand."""
    eq = (attrs or {}).get("equation")
    if isinstance(eq, str) and "." not in eq:
        lhs = eq.replace(" ", "").split("->", 1)[0]
        terms = lhs.split(",")
        if len(terms) == len(input_shapes) and all(
                len(t) == len(s) for t, s in zip(terms, input_shapes)):
            extent: Dict[str, int] = {}
            for t, s in zip(terms, input_shapes):
                for c, d in zip(t, s):
                    extent[c] = int(d)
            vol = 1.0
            for d in extent.values():
                vol *= d
            read, written = _io_bytes(input_shapes, input_dtypes,
                                      output_shapes)
            return OpCost(2.0 * vol, read, written, f"einsum {eq}")
    if len(input_shapes) >= 2 and all(len(s) >= 2
                                      for s in input_shapes[:2]):
        return matmul_cost(input_shapes, input_dtypes, {}, output_shapes)
    n = max((_numel(s) for s in input_shapes), default=0)
    read, written = _io_bytes(input_shapes, input_dtypes, output_shapes)
    return OpCost(2.0 * n, read, written, "einsum (no equation)")


def collective_cost(primitive: str, nbytes: float,
                    n_devices: int) -> OpCost:
    """Wire bytes of one collective under the ring algorithms (all_reduce
    moves 2·(n−1)/n·B, all_gather/reduce_scatter/all_to_all (n−1)/n·B,
    broadcast/p2p B)."""
    n = max(int(n_devices), 1)
    p = primitive.lower()
    if n == 1:
        wire = 0.0
    elif "all_reduce" in p or "allreduce" in p:
        wire = 2.0 * (n - 1) / n * nbytes
    elif ("all_gather" in p or "allgather" in p
          or "reduce_scatter" in p or "all_to_all" in p
          or "alltoall" in p):
        wire = (n - 1) / n * nbytes
    else:                                # broadcast / send / recv / reduce
        wire = float(nbytes)
    return OpCost(0.0, wire, 0.0, f"{primitive} wire bytes n={n}")


# --------------------------------------------------------------------------
# Registry attachment
# --------------------------------------------------------------------------
#: op name -> cost_fn; categories not named here fall back through
#: _CATEGORY_MODELS
COST_MODELS: Dict[str, Callable] = {}


def _fill_models():
    mm = matmul_cost
    for name in ("matmul", "mm", "bmm", "addmm", "linear", "fc",
                 "matmul_v2"):
        COST_MODELS[name] = mm
    for name in ("conv2d", "conv1d", "conv3d", "conv2d_transpose",
                 "depthwise_conv2d"):
        COST_MODELS[name] = conv2d_cost
    for name in ("flash_attention", "scaled_dot_product_attention",
                 "block_multihead_attention"):
        COST_MODELS[name] = attention_cost
    for name in ("layer_norm", "rms_norm", "batch_norm", "group_norm",
                 "instance_norm", "fused_layer_norm", "fused_rms_norm"):
        COST_MODELS[name] = norm_cost
    COST_MODELS["softmax"] = softmax_cost
    COST_MODELS["log_softmax"] = softmax_cost
    for name in ("cross_entropy", "softmax_with_cross_entropy",
                 "bce_with_logits"):
        COST_MODELS[name] = cross_entropy_cost
    COST_MODELS["fused_linear_cross_entropy"] = linear_cross_entropy_cost
    for name in ("embedding", "gather", "gather_nd", "index_select",
                 "take_along_axis"):
        COST_MODELS[name] = gather_cost
    COST_MODELS["embedding_bag"] = embedding_bag_cost
    COST_MODELS["scatter_add"] = scatter_add_cost
    for name in ("sum", "mean", "max", "min", "prod", "reduce_sum",
                 "logsumexp", "cumsum", "argmax", "argmin", "norm"):
        COST_MODELS[name] = reduction_cost
    ew1 = elementwise_cost(1.0)
    for name in ("add", "subtract", "multiply", "divide", "relu", "abs",
                 "scale", "clip", "where", "maximum", "minimum", "cast",
                 "add_n", "sqrt", "rsqrt", "square", "floor", "ceil",
                 "sign", "tril", "triu"):
        COST_MODELS[name] = ew1
    ew4 = elementwise_cost(4.0)          # transcendental-ish
    for name in ("exp", "log", "tanh", "sigmoid", "gelu", "silu", "swish",
                 "erf", "sin", "cos", "pow", "softplus", "log1p"):
        COST_MODELS[name] = ew4
    COST_MODELS["einsum"] = einsum_cost
    # dispatch-level ops with no registry entry (tensor protocol, model
    # composites)
    COST_MODELS["getitem"] = elementwise_cost(0.0)   # a slice: traffic only
    COST_MODELS["rotary_embedding"] = elementwise_cost(6.0)
    # the fused ops (compile/fusion's rewrite targets)
    COST_MODELS["fused_bias_act"] = elementwise_cost(5.0)
    COST_MODELS["fused_residual_norm"] = fused_residual_norm_cost
    COST_MODELS["fused_norm_linear"] = fused_norm_linear_cost
    COST_MODELS["fused_rope_proj"] = fused_rope_proj_cost
    # K2 and K3, which no registry op names (the attention's backward)
    COST_MODELS["flash_attention_bwd_dq"] = flash_attention_bwd_dq_cost
    COST_MODELS["flash_attention_bwd_dkv"] = flash_attention_bwd_dkv_cost


_fill_models()

#: category fallback when an op has no named model
_CATEGORY_MODELS: Dict[str, Callable] = {
    "linalg": matmul_cost,
    "conv": conv2d_cost,
    "attention": attention_cost,
    "norm": norm_cost,
    "reduction": reduction_cost,
    "loss": cross_entropy_cost,
    "activation": elementwise_cost(4.0),
    "math": elementwise_cost(1.0),
    "manipulation": elementwise_cost(0.0),
    "creation": elementwise_cost(0.0),
    "indexing": gather_cost,
    "search": reduction_cost,
    "fusion": elementwise_cost(4.0),
}


def attach_cost_models() -> int:
    """Attach the per-op-class formulas to the live op registry
    (``OpDef.cost_fn``). Idempotent; a cost_fn a ``register(...,
    cost_fn=)`` site set wins. Returns the number of ops that now carry a
    model."""
    from ...ops import registry as reg

    n = 0
    for name, od in reg.OPS.items():
        if od.cost_fn is None:
            fn = COST_MODELS.get(name) or _CATEGORY_MODELS.get(od.category)
            if fn is not None:
                od.cost_fn = fn
        if od.cost_fn is not None:
            n += 1
    return n


def cost_of(op_name: str, input_shapes: Sequence, input_dtypes=(),
            attrs: Optional[dict] = None,
            output_shapes: Sequence = ()) -> Optional[OpCost]:
    """Modeled cost of one op execution, or None when neither the registry
    nor the name and category tables know the op. Precedence: the
    registry's cost_fn (a ``register(..., cost_fn=)`` override), the
    per-name formula, the category fallback."""
    fn = None
    category = None
    try:
        from ...ops import registry as reg
        od = reg.OPS.get(op_name)
        if od is not None:
            fn = od.cost_fn
            category = od.category
    except Exception:
        fn = None
    if fn is None:
        fn = COST_MODELS.get(op_name)
    if fn is None and category is not None:
        fn = _CATEGORY_MODELS.get(category)
    if fn is None:
        return None
    try:
        return fn(list(map(tuple, input_shapes)), list(input_dtypes),
                  dict(attrs or {}), list(map(tuple, output_shapes)))
    except Exception:
        return None


# --------------------------------------------------------------------------
# The measured count: FlopCounterMode and the aten ops' bytes
# --------------------------------------------------------------------------
def _k1_flops(q, k, v, causal, scale, *rest, out_shape=None, **kw):
    """FlopCounterMode's formula for K1's op
    (``paddle_tpu_torch::flash_attention_fwd``), shapes (B, S, H, D):
    QKᵀ and PV over the pairs the kernel computes, as torch's own
    ``sdpa_flop_count`` counts them (the softmax is not counted)."""
    b, s_q, h, d = q
    s_kv = k[1]
    pairs = causal_pairs(s_q, s_kv) if causal else s_q * s_kv
    return 4 * b * h * pairs * d


def _custom_flop_formulas() -> dict:
    from ...ops.cuda import flash_attention  # noqa: F401 (K1's op)
    return {torch.ops.paddle_tpu_torch.flash_attention_fwd: _k1_flops}


class _ByteCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts what each aten op reads and writes (``bytes_accessed``), the
    bytes of the storages the call read that it did not make
    (``argument_bytes``), and the peak of the storages it made that are
    alive at once (``temp_peak``), from the tensors' shapes: a storage is
    live while a tensor on it is."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.argument_bytes = 0
        self._args = set()
        self._made: Dict[int, list] = {}      # storage key -> [refs, bytes]
        self.live = 0
        self.temp_peak = 0

    @staticmethod
    def _key(t):
        if t.device.type == "meta":
            return None
        st = t.untyped_storage()
        return (t.device.type, t.device.index, st.data_ptr())

    def _release(self, key):
        ent = self._made.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live -= ent[1]
            del self._made[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import weakref
        out = func(*args, **(kwargs or {}))
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for t in ins:
            self.bytes_accessed += t.numel() * t.element_size()
            key = self._key(t)
            if key is not None and key not in self._made \
                    and key not in self._args:
                self._args.add(key)
                self.argument_bytes += t.untyped_storage().nbytes()
        for t in outs:
            self.bytes_accessed += t.numel() * t.element_size()
            key = self._key(t)
            if key is None or key in self._args:
                continue                  # an in-place op on an argument
            ent = self._made.get(key)
            if ent is None:
                ent = self._made[key] = [0, t.untyped_storage().nbytes()]
                self.live += ent[1]
                self.temp_peak = max(self.temp_peak, self.live)
            ent[0] += 1
            weakref.finalize(t, self._release, key)
        return out


def counted_cost(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under FlopCounterMode (with K1's
    op priced by ``_k1_flops``) and a byte counter. Returns ``(output,
    {"flops", "bytes_accessed", "transcendentals", "argument_bytes",
    "temp_peak_bytes"})``: the port's counterpart of the JAX package's
    ``xla_cost`` (``transcendentals`` is 0: FlopCounterMode counts the
    products only)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False,
                              custom_mapping=_custom_flop_formulas())
    nbytes = _ByteCounter()
    with counter, nbytes:
        out = fn(*args, **kwargs)
    return out, {"flops": float(counter.get_total_flops()),
                 "bytes_accessed": float(nbytes.bytes_accessed),
                 "transcendentals": 0.0,
                 "argument_bytes": int(nbytes.argument_bytes),
                 "temp_peak_bytes": int(nbytes.temp_peak)}


def relative_error(modeled: float, measured: float) -> float:
    """|modeled − measured| / max(measured, 1): the cross-check metric."""
    return abs(modeled - measured) / max(abs(measured), 1.0)


def roofline_bound(cost: OpCost, peak_flops: float,
                   peak_bw: float) -> dict:
    """Where the op sits on the roofline: the attainable FLOP/s at its
    arithmetic intensity, whether compute or bandwidth bounds it, and
    ``seconds``, the least time the card takes for its FLOPs and bytes
    (the larger of the two)."""
    ai = cost.arithmetic_intensity
    attainable = min(peak_flops, peak_bw * ai) if ai > 0 else 0.0
    ridge = peak_flops / peak_bw if peak_bw else math.inf
    return {"arithmetic_intensity": ai,
            "attainable_flops": attainable,
            "bound": "compute" if ai >= ridge else "bandwidth",
            "ridge_intensity": ridge,
            "seconds": max(cost.flops / peak_flops if peak_flops else 0.0,
                           cost.bytes / peak_bw if peak_bw else 0.0)}
