"""Pure-numpy evaluator for the exported ONNX op subset.

The port's own copy of the JAX package's evaluator (it imports nothing
of that package). Without onnxruntime, exported models are verified by
executing the .onnx file with this interpreter and comparing logits
against the live model; where onnxruntime is available the same files
run there (op semantics follow the ONNX spec).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import proto


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _pool_view(x: np.ndarray, kh: int, kw: int, sh: int, sw: int):
    """(N, C, OH, OW, kh, kw) sliding-window view of NCHW input."""
    N, C, H, W = x.shape
    oh = (H - kh) // sh + 1
    ow = (W - kw) // sw + 1
    s = x.strides
    return np.lib.stride_tricks.as_strided(
        x, (N, C, oh, ow, kh, kw),
        (s[0], s[1], s[2] * sh, s[3] * sw, s[2], s[3]),
        writeable=False)


def _pad_nchw(x, pads, value=0.0):
    # ONNX pads: [h_begin, w_begin, h_end, w_end]
    hb, wb, he, we = pads
    return np.pad(x, ((0, 0), (0, 0), (hb, he), (wb, we)),
                  constant_values=value)


def _auto_pads(auto_pad, in_hw, k_hw, strides):
    """SAME_UPPER/SAME_LOWER pads per the ONNX spec."""
    pads = [0, 0, 0, 0]
    for i in (0, 1):
        out = -(-in_hw[i] // strides[i])
        total = max((out - 1) * strides[i] + k_hw[i] - in_hw[i], 0)
        lo = total // 2 if auto_pad == "SAME_UPPER" else total - total // 2
        pads[i], pads[i + 2] = lo, total - lo
    return pads


def _resolve_pads(attrs, in_hw, k_hw, strides):
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        return _auto_pads(auto, in_hw, k_hw, strides)
    if auto == "VALID":
        return [0, 0, 0, 0]
    return attrs.get("pads", [0, 0, 0, 0])


def _conv(x, w, b, attrs):
    group = int(attrs.get("group", 1))
    strides = attrs.get("strides", [1, 1])
    dil = attrs.get("dilations", [1, 1])
    eff_k = [(w.shape[2] - 1) * dil[0] + 1, (w.shape[3] - 1) * dil[1] + 1]
    pads = _resolve_pads(attrs, x.shape[2:], eff_k, strides)
    x = _pad_nchw(x, pads)
    if list(dil) != [1, 1]:
        # dilate the kernel explicitly
        kh, kw = w.shape[2], w.shape[3]
        wk = np.zeros(w.shape[:2] + ((kh - 1) * dil[0] + 1,
                                     (kw - 1) * dil[1] + 1), w.dtype)
        wk[:, :, ::dil[0], ::dil[1]] = w
        w = wk
    N, C, H, W = x.shape
    O, Cg, kh, kw = w.shape
    og = O // group
    outs = []
    for g in range(group):
        xg = x[:, g * Cg:(g + 1) * Cg]
        wg = w[g * og:(g + 1) * og]
        view = _pool_view(xg, kh, kw, strides[0], strides[1])
        # (N, C, OH, OW, kh, kw) x (og, C, kh, kw) -> (N, og, OH, OW)
        outs.append(np.einsum("nchwij,ocij->nohw", view, wg,
                              optimize=True))
    y = np.concatenate(outs, axis=1)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y.astype(np.float32)


def _maxpool(x, attrs):
    kh, kw = attrs["kernel_shape"]
    sh, sw = attrs.get("strides", [kh, kw])
    pads = _resolve_pads(attrs, x.shape[2:], [kh, kw], [sh, sw])
    if attrs.get("ceil_mode", 0):
        N, C, H, W = x.shape
        eh = -(-(H + pads[0] + pads[2] - kh) // sh) * sh + kh
        ew = -(-(W + pads[1] + pads[3] - kw) // sw) * sw + kw
        pads = [pads[0], pads[1],
                max(pads[2], eh - H - pads[0]),
                max(pads[3], ew - W - pads[1])]
    xp = _pad_nchw(x, pads, value=-np.inf)
    return _pool_view(xp, kh, kw, sh, sw).max(axis=(4, 5))


def _avgpool(x, attrs):
    kh, kw = attrs["kernel_shape"]
    sh, sw = attrs.get("strides", [kh, kw])
    pads = _resolve_pads(attrs, x.shape[2:], [kh, kw], [sh, sw])
    include_pad = bool(attrs.get("count_include_pad", 0))
    xp = _pad_nchw(x, pads)
    s = _pool_view(xp, kh, kw, sh, sw).sum(axis=(4, 5))
    if include_pad:
        return (s / (kh * kw)).astype(x.dtype)
    ones = _pad_nchw(np.ones_like(x), pads)
    cnt = _pool_view(ones, kh, kw, sh, sw).sum(axis=(4, 5))
    return (s / cnt).astype(x.dtype)


def _gemm(a, b, c, attrs):
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    y = alpha * (a @ b)
    if c is not None:
        y = y + beta * c
    return y


def _reshape(x, shape):
    shape = [int(s) for s in shape]
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def run(model_bytes: bytes, feeds: Dict[str, np.ndarray]
        ) -> List[np.ndarray]:
    """Execute a serialized ModelProto on numpy feeds; returns the graph
    outputs in declared order."""
    g = proto.parse_model(model_bytes)["graph"]
    env: Dict[str, np.ndarray] = dict(g["initializers"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})

    def get(name):
        return env[name] if name else None

    for nd in g["nodes"]:
        op = nd["op_type"]
        ins = [get(n) for n in nd["input"]]
        attrs = nd["attrs"]
        if op == "Conv":
            out = _conv(ins[0], ins[1],
                        ins[2] if len(ins) > 2 else None, attrs)
        elif op == "Relu":
            out = np.maximum(ins[0], 0)
        elif op == "MaxPool":
            out = _maxpool(ins[0], attrs)
        elif op == "AveragePool":
            out = _avgpool(ins[0], attrs)
        elif op == "GlobalAveragePool":
            out = ins[0].mean(axis=(2, 3), keepdims=True)
        elif op == "BatchNormalization":
            x, scale, bias, mean, var = ins[:5]
            eps = attrs.get("epsilon", 1e-5)
            shp = (1, -1) + (1,) * (x.ndim - 2)
            out = ((x - mean.reshape(shp))
                   / np.sqrt(var.reshape(shp) + eps)
                   * scale.reshape(shp) + bias.reshape(shp))
            out = out.astype(x.dtype)
        elif op == "Gemm":
            out = _gemm(ins[0], ins[1],
                        ins[2] if len(ins) > 2 else None, attrs)
        elif op == "MatMul":
            out = ins[0] @ ins[1]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Reshape":
            out = _reshape(ins[0], ins[1])
        elif op == "Flatten":
            ax = attrs.get("axis", 1)
            out = ins[0].reshape(int(np.prod(ins[0].shape[:ax])), -1)
        elif op == "Softmax":
            out = _softmax(ins[0], attrs.get("axis", -1))
        elif op == "Tanh":
            out = np.tanh(ins[0])
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-ins[0]))
        elif op == "Identity":
            out = ins[0]
        else:
            raise NotImplementedError(f"runtime op {op}")
        env[nd["output"][0]] = out
    return [env[o["name"]] for o in g["outputs"]]
