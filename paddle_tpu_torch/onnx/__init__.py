"""paddle.onnx — native ONNX export (counterpart of
``paddle_tpu/onnx/__init__.py``).

Reference surface: python/paddle/onnx/export.py (``paddle.onnx.export``
delegates to paddle2onnx). The model runs once under the dispatcher's
export hook (``core/dispatch.register_export_hook``), which records each
op with its semantic parameters (stride, padding, axis, ...); the
recorded graph is mapped to ONNX ops and serialized by the bundled
protobuf writer (``onnx/proto.py``: no onnx package is needed). Exported
files execute on onnxruntime; the bundled numpy evaluator
(``onnx/runtime.py``) verifies them without it.

Supported subset, the JAX package's: the convnet ops (Conv/BN/Relu/Pool/
Gemm/Reshape/Flatten/Add/.../Softmax): LeNet and the ResNet family
export and verify end to end. Unsupported ops raise
``NotImplementedError`` naming the op. A model on the card exports as
one on the CPU: the trace reads every op's inputs back to the host.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.place import current_device
from ..core.tensor import Tensor
from . import proto, runtime

__all__ = ["export", "run"]


def _sanitize(name: str) -> str:
    return re.sub(r"[^0-9a-zA-Z_./]", "_", name)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (bf16/fp16 as float32: the exported subset is fp32)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype in (torch.bfloat16, torch.float16):
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


class _Trace:
    def __init__(self):
        self.records: List[tuple] = []
        self.keepalive: List[Any] = []  # pin Tensor ids during the trace

    def hook(self, op_name, tensor_inputs, out_tensors, attrs):
        self.records.append((op_name, [id(t) for t in tensor_inputs],
                             [_host(t._data) for t in tensor_inputs],
                             [id(t) for t in out_tensors],
                             [tuple(t.shape) for t in out_tensors],
                             dict(attrs)))
        self.keepalive.extend(tensor_inputs)
        self.keepalive.extend(out_tensors)


def _onnx_pads(padding, op: str):
    """(lo,hi)-pairs / 'SAME' / 'VALID' -> (pads list, auto_pad)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [0, 0, 0, 0], None
        return None, "SAME_UPPER"
    pairs = [tuple(p) for p in padding]
    if len(pairs) != 2:
        raise NotImplementedError(f"{op}: only 2-D spatial export")
    return [pairs[0][0], pairs[1][0], pairs[0][1], pairs[1][1]], None


class _Builder:
    def __init__(self, name_of: Dict[int, str],
                 params: Dict[int, np.ndarray]):
        self.name_of = name_of          # tensor id -> value name
        self.params = params            # tensor id -> ndarray (weights)
        self.nodes: List[bytes] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.counter = 0

    def fresh(self, hint="t"):
        self.counter += 1
        return f"{hint}_{self.counter}"

    def init_const(self, name: str, arr: np.ndarray) -> str:
        self.initializers[name] = np.asarray(arr)
        return name

    def in_name(self, tid: int, value: np.ndarray) -> str:
        nm = self.name_of.get(tid)
        if nm is None:
            # a tensor from outside the traced graph: bake as initializer
            nm = self.fresh("const")
            self.name_of[tid] = nm
            self.initializers[nm] = np.asarray(value)
        elif tid in self.params and nm not in self.initializers:
            self.initializers[nm] = self.params[tid]
        return nm

    def out_name(self, tid: int) -> str:
        nm = self.name_of.get(tid)
        if nm is None:
            nm = self.name_of[tid] = self.fresh()
        return nm

    def emit(self, op_type, ins, outs, attrs=None):
        self.nodes.append(proto.node(
            op_type, ins, outs, name=self.fresh(op_type), attrs=attrs))


_ELTWISE = {"add": "Add", "subtract": "Sub", "sub": "Sub",
            "multiply": "Mul", "mul": "Mul", "divide": "Div",
            "div": "Div"}
_UNARY = {"relu": "Relu", "tanh": "Tanh", "sigmoid": "Sigmoid"}


def _map_record(b: _Builder, op, in_ids, in_vals, out_ids, out_shapes,
                attrs):
    if op == "batch_norm":
        # the port's op also takes the running statistics as inputs; the
        # export reads them from its attrs, as the JAX package does
        n = 1 + bool(attrs.get("has_w")) + bool(attrs.get("has_b"))
        in_ids, in_vals = in_ids[:n], in_vals[:n]
    ins = [b.in_name(t, v) for t, v in zip(in_ids, in_vals)]
    outs = [b.out_name(t) for t in out_ids]

    if op in _UNARY:
        b.emit(_UNARY[op], ins, outs)
    elif op in _ELTWISE:
        b.emit(_ELTWISE[op], ins, outs)
    elif op == "conv2d":
        if attrs.get("channel_last"):
            raise NotImplementedError("conv2d NHWC export")
        pads, auto = _onnx_pads(attrs["padding"], op)
        a: Dict[str, Any] = {"strides": list(attrs["stride"]),
                             "dilations": list(attrs["dilation"]),
                             "group": int(attrs["groups"])}
        if auto:
            a["auto_pad"] = auto
        else:
            a["pads"] = pads
        b.emit("Conv", ins, outs, a)
    elif op in ("max_pool2d", "avg_pool2d"):
        if attrs.get("channel_last"):
            raise NotImplementedError(f"{op} NHWC export")
        pads, auto = _onnx_pads(attrs["padding"], op)
        a = {"kernel_shape": list(attrs["kernel_size"]),
             "strides": list(attrs["stride"]),
             "ceil_mode": int(bool(attrs.get("ceil_mode")))}
        if auto:
            a["auto_pad"] = auto
        else:
            a["pads"] = pads
        if op == "avg_pool2d":
            a["count_include_pad"] = 0 if attrs.get("exclusive", True) \
                else 1
            b.emit("AveragePool", ins, outs, a)
        else:
            b.emit("MaxPool", ins, outs, a)
    elif op == "adaptive_avg_pool2d":
        osz = attrs.get("output_size")
        osz = (osz, osz) if isinstance(osz, int) else tuple(osz)
        if tuple(osz) != (1, 1):
            raise NotImplementedError(
                "adaptive_avg_pool2d export needs output_size 1")
        b.emit("GlobalAveragePool", ins, outs)
    elif op == "batch_norm":
        x_name = ins[0]
        C = attrs["mean"].shape[0]
        widx = 1
        scale = (ins[widx] if attrs["has_w"]
                 else b.init_const(b.fresh("bn_scale"),
                                   np.ones(C, np.float32)))
        widx += 1 if attrs["has_w"] else 0
        bias = (ins[widx] if attrs["has_b"]
                else b.init_const(b.fresh("bn_bias"),
                                  np.zeros(C, np.float32)))
        mean = b.init_const(b.fresh("bn_mean"), attrs["mean"])
        var = b.init_const(b.fresh("bn_var"), attrs["var"])
        b.emit("BatchNormalization", [x_name, scale, bias, mean, var],
               outs, {"epsilon": float(attrs["epsilon"])})
    elif op == "linear":
        if len(in_vals[0].shape) == 2:
            b.emit("Gemm", ins, outs)
        else:
            mm = b.fresh("matmul")
            b.emit("MatMul", ins[:2], [mm])
            if len(ins) > 2:
                b.emit("Add", [mm, ins[2]], outs)
            else:
                b.emit("Identity", [mm], outs)
    elif op == "matmul":
        b.emit("MatMul", ins[:2], outs)
    elif op == "reshape":
        out_shape = [int(s) for s in out_shapes[0]]
        if tuple(in_vals[0].shape[:1]) == tuple(out_shape[:1]):
            # batch dim preserved: emit 0 (copy) so the graph serves any
            # batch size; otherwise the traced shape is baked in (the
            # export is batch-specialized for that reshape)
            shape = [0] + out_shape[1:]
        else:
            shape = out_shape
        shp = b.init_const(b.fresh("shape"),
                           np.asarray(shape, np.int64))
        b.emit("Reshape", [ins[0], shp], outs)
    elif op == "flatten":
        s_ax = int(attrs.get("start_axis", 1))
        e_ax = int(attrs.get("stop_axis", len(in_vals[0].shape) - 1))
        if s_ax >= 1 and e_ax == len(in_vals[0].shape) - 1:
            b.emit("Flatten", ins, outs, {"axis": s_ax})
        else:
            # partial flatten: exact Reshape to the traced output shape
            out_shape = [int(s) for s in out_shapes[0]]
            shape = ([0] + out_shape[1:]
                     if s_ax >= 1 and tuple(in_vals[0].shape[:1])
                     == tuple(out_shape[:1]) else out_shape)
            shp = b.init_const(b.fresh("shape"),
                               np.asarray(shape, np.int64))
            b.emit("Reshape", [ins[0], shp], outs)
    elif op == "softmax":
        ax = int(attrs.get("axis", -1))
        b.emit("Softmax", ins, outs, {"axis": ax})
    elif op == "dropout":
        b.emit("Identity", ins, outs)
    else:
        raise NotImplementedError(
            f"ONNX export does not support op {op!r} yet "
            f"(supported: convnet subset — see paddle_tpu_torch/onnx)")


def _example_inputs(input_spec):
    out = []
    for spec in input_spec:
        if isinstance(spec, Tensor):
            out.append(spec)
            continue
        if isinstance(spec, np.ndarray):
            out.append(Tensor(torch.as_tensor(spec,
                                              device=current_device())))
            continue
        shape = tuple(1 if (s is None or s == -1) else int(s)
                      for s in spec.shape)
        dtype = convert_dtype(str(getattr(spec, "dtype", "float32"))
                              or "float32")
        out.append(Tensor(torch.zeros(shape, dtype=dtype,
                                      device=current_device())))
    return out


def export(layer, path: str, input_spec=None, opset_version: int = 13,
           **configs) -> str:
    """Export ``layer`` to ``path + '.onnx'`` (reference
    paddle.onnx.export contract). Returns the written file path."""
    if input_spec is None:
        raise ValueError("paddle.onnx.export requires input_spec")
    inputs = _example_inputs(list(input_spec))

    params: Dict[int, np.ndarray] = {}
    name_of: Dict[int, str] = {}
    if hasattr(layer, "named_parameters"):
        for n, p in layer.named_parameters():
            name_of[id(p)] = _sanitize(n)
            params[id(p)] = _host(p._data)
    if hasattr(layer, "named_buffers"):
        for n, p in layer.named_buffers():
            name_of[id(p)] = _sanitize(n)
            params[id(p)] = _host(p._data)
    graph_inputs = []
    for i, t in enumerate(inputs):
        name_of[id(t)] = f"x{i}"
        graph_inputs.append(proto.value_info(
            f"x{i}", (None,) + tuple(t.shape[1:]),
            proto.NP2ONNX[_np_dtype(t.dtype)]))

    was_training = getattr(layer, "training", False)
    if hasattr(layer, "eval"):
        layer.eval()
    tr = _Trace()
    dispatch.register_export_hook(tr.hook)
    try:
        with dispatch.no_grad():
            result = layer(*inputs)
    finally:
        dispatch.unregister_export_hook(tr.hook)
        if was_training and hasattr(layer, "train"):
            layer.train()

    outputs = result if isinstance(result, (list, tuple)) else [result]
    out_tensors = [o for o in outputs if isinstance(o, Tensor)]

    b = _Builder(name_of, params)
    for rec in tr.records:
        _map_record(b, *rec)

    graph_outputs = []
    for i, t in enumerate(out_tensors):
        nm = b.name_of.get(id(t))
        if nm is None:
            raise RuntimeError("model output was not produced by a "
                               "traced op")
        graph_outputs.append(proto.value_info(
            nm, (None,) + tuple(t.shape[1:]),
            proto.NP2ONNX[_np_dtype(t.dtype)]))

    inits = [proto.tensor_proto(n, a) for n, a in b.initializers.items()]
    g = proto.graph(b.nodes, _sanitize(type(layer).__name__ or "model"),
                    inits, graph_inputs, graph_outputs)
    blob = proto.model(g, opset=opset_version)
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path


def run(path: str, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """Execute an exported .onnx file with the bundled numpy runtime."""
    with open(path, "rb") as f:
        blob = f.read()
    return runtime.run(blob, feeds)
