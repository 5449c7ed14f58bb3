"""Minimal ONNX protobuf writer/reader — no onnx package dependency.

The image ships neither ``onnx`` nor ``protoc``-compiled bindings for it,
so this module encodes/decodes the (stable) ONNX wire format directly:
ModelProto / GraphProto / NodeProto / AttributeProto / TensorProto /
ValueInfoProto with the field numbers from onnx/onnx.proto3. Only the
subset the exporter emits is supported — which is exactly what the
bundled numpy runtime (onnx/runtime.py) and external onnxruntime need.

Reference surface: python/paddle/onnx/export.py (delegates to
paddle2onnx); here the encoder is native. The port's own copy of the JAX
package's writer: files from either package parse alike.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9
DOUBLE = 11

NP2ONNX = {np.dtype(np.float32): FLOAT, np.dtype(np.int64): INT64,
           np.dtype(np.int32): INT32, np.dtype(np.bool_): BOOL,
           np.dtype(np.float64): DOUBLE, np.dtype(np.uint8): UINT8,
           np.dtype(np.int8): INT8}
ONNX2NP = {v: k for k, v in NP2ONNX.items()}

# AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR = 1, 2, 3, 4
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


# ---------------------------------------------------------------- writer
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def _f_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _f_str(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode())


def _f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def _f_packed_varints(field: int, values) -> bytes:
    body = b"".join(_varint(int(v)) for v in values)
    return _f_bytes(field, body)


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = NP2ONNX[arr.dtype]
    msg = _f_packed_varints(1, arr.shape)            # dims
    msg += _f_varint(2, dt)                          # data_type
    msg += _f_str(8, name)                           # name
    msg += _f_bytes(9, arr.tobytes())                # raw_data
    return msg


def attribute(name: str, value) -> bytes:
    msg = _f_str(1, name)
    if isinstance(value, float):
        msg += _f_float(2, value) + _f_varint(20, A_FLOAT)
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        msg += _f_varint(3, int(value)) + _f_varint(20, A_INT)
    elif isinstance(value, str):
        msg += _f_bytes(4, value.encode()) + _f_varint(20, A_STRING)
    elif isinstance(value, np.ndarray):
        msg += _f_bytes(5, tensor_proto(name + "_t", value))
        msg += _f_varint(20, A_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            body = b"".join(_tag(7, 5) + struct.pack("<f", v)
                            for v in value)
            msg += body + _f_varint(20, A_FLOATS)
        else:
            msg += _f_packed_varints(8, value) + _f_varint(20, A_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return msg


def node(op_type: str, inputs: List[str], outputs: List[str],
         name: str = "", attrs: Optional[Dict[str, Any]] = None) -> bytes:
    msg = b"".join(_f_str(1, i) for i in inputs)
    msg += b"".join(_f_str(2, o) for o in outputs)
    if name:
        msg += _f_str(3, name)
    msg += _f_str(4, op_type)
    for k, v in (attrs or {}).items():
        msg += _f_bytes(5, attribute(k, v))
    return msg


def value_info(name: str, shape: Tuple[int, ...], elem_type: int) -> bytes:
    dims = b""
    for d in shape:
        if d is None or d < 0:
            dims += _f_bytes(1, _f_str(2, "N"))      # dim_param
        else:
            dims += _f_bytes(1, _f_varint(1, d))     # dim_value
    tens = _f_varint(1, elem_type) + _f_bytes(2, dims)
    return _f_str(1, name) + _f_bytes(2, _f_bytes(1, tens))


def graph(nodes: List[bytes], name: str, initializers: List[bytes],
          inputs: List[bytes], outputs: List[bytes]) -> bytes:
    msg = b"".join(_f_bytes(1, n) for n in nodes)
    msg += _f_str(2, name)
    msg += b"".join(_f_bytes(5, t) for t in initializers)
    msg += b"".join(_f_bytes(11, v) for v in inputs)
    msg += b"".join(_f_bytes(12, v) for v in outputs)
    return msg


def model(graph_bytes: bytes, opset: int = 13,
          producer: str = "paddle_tpu_torch") -> bytes:
    msg = _f_varint(1, 8)                            # ir_version
    msg += _f_str(2, producer)
    msg += _f_bytes(7, graph_bytes)
    msg += _f_bytes(8, _f_str(1, "") + _f_varint(2, opset))  # opset_import
    return msg


# ---------------------------------------------------------------- reader
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _parse_packed_varints(data: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = FLOAT
    name = ""
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, v in _fields(buf):
        if field == 1:
            dims += _parse_packed_varints(v) if wire == 2 else [v]
        elif field == 2:
            dtype = v
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
        elif field == 4:
            floats += (list(np.frombuffer(v, "<f4")) if wire == 2
                       else [struct.unpack("<f", v)[0]])
        elif field == 7:
            ints += _parse_packed_varints(v) if wire == 2 else [v]
    np_dt = ONNX2NP[dtype]
    if raw:
        arr = np.frombuffer(raw, np_dt).reshape(dims)
    elif floats:
        arr = np.asarray(floats, np_dt).reshape(dims)
    else:
        arr = np.asarray([_signed(i) for i in ints], np_dt).reshape(dims)
    return name, arr


def parse_attribute(buf: bytes) -> Tuple[str, Any]:
    name, value, atype = "", None, None
    ints: List[int] = []
    floats: List[float] = []
    for field, wire, v in _fields(buf):
        if field == 1:
            name = v.decode()
        elif field == 2:
            value = struct.unpack("<f", v)[0]
        elif field == 3:
            ints.append(_signed(v))
        elif field == 4:
            value = v.decode()
        elif field == 5:
            value = parse_tensor(v)[1]
        elif field == 7:
            floats += (list(np.frombuffer(v, "<f4")) if wire == 2
                       else [struct.unpack("<f", v)[0]])
        elif field == 8:
            ints += ([_signed(i) for i in _parse_packed_varints(v)]
                     if wire == 2 else [_signed(v)])
        elif field == 20:
            atype = v
    if atype == A_INT:
        return name, ints[0]
    if atype == A_INTS:
        return name, ints
    if atype == A_FLOATS:
        return name, floats
    return name, value


def parse_node(buf: bytes) -> dict:
    out = {"input": [], "output": [], "op_type": "", "name": "",
           "attrs": {}}
    for field, _w, v in _fields(buf):
        if field == 1:
            out["input"].append(v.decode())
        elif field == 2:
            out["output"].append(v.decode())
        elif field == 3:
            out["name"] = v.decode()
        elif field == 4:
            out["op_type"] = v.decode()
        elif field == 5:
            k, val = parse_attribute(v)
            out["attrs"][k] = val
    return out


def parse_value_info(buf: bytes) -> dict:
    name, shape, elem = "", [], FLOAT
    for field, _w, v in _fields(buf):
        if field == 1:
            name = v.decode()
        elif field == 2:
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:
                            for f4, _w4, v4 in _fields(v3):
                                if f4 == 1:
                                    dv = None
                                    for f5, _w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = v5
                                    shape.append(dv)
    return {"name": name, "shape": shape, "elem_type": elem}


def parse_graph(buf: bytes) -> dict:
    g = {"nodes": [], "name": "", "initializers": {}, "inputs": [],
         "outputs": []}
    for field, _w, v in _fields(buf):
        if field == 1:
            g["nodes"].append(parse_node(v))
        elif field == 2:
            g["name"] = v.decode()
        elif field == 5:
            n, arr = parse_tensor(v)
            g["initializers"][n] = arr
        elif field == 11:
            g["inputs"].append(parse_value_info(v))
        elif field == 12:
            g["outputs"].append(parse_value_info(v))
    return g


def parse_model(buf: bytes) -> dict:
    m = {"ir_version": None, "producer": "", "opset": None, "graph": None}
    for field, _w, v in _fields(buf):
        if field == 1:
            m["ir_version"] = v
        elif field == 2:
            m["producer"] = v.decode()
        elif field == 7:
            m["graph"] = parse_graph(v)
        elif field == 8:
            for f2, _w2, v2 in _fields(v):
                if f2 == 2:
                    m["opset"] = v2
    return m
