"""Dtype names <-> ``torch.dtype`` (counterpart of ``paddle_tpu/core/dtype.py``).

The JAX package's dtypes are numpy dtype instances; the port's are
``torch.dtype``s under the same Paddle names (``paddle.float32``,
``paddle.bfloat16``, ...). Paddle-style aliases (``fp32``, ``bf16``, ...)
and numpy dtypes are accepted as in the JAX package.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
    # paddle-style aliases
    "fp16": float16,
    "bf16": bfloat16,
    "fp32": float32,
    "fp64": float64,
}
_DTYPE_TO_NAME = {}
for _n, _d in _NAME_TO_DTYPE.items():       # the canonical names come first
    _DTYPE_TO_NAME.setdefault(_d, _n)

FLOATING = {float16, bfloat16, float32, float64}
INTEGER = {uint8, int8, int16, int32, int64}
COMPLEX = {complex64, complex128}

#: process-wide default float dtype (reference set_default_dtype)
_DEFAULT_FLOAT = {"value": float32}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name (``"bfloat16"``, ``"paddle.float32"``, ``"bf16"``), a
    numpy dtype, a Python type or a ``torch.dtype`` -> ``torch.dtype``;
    ``None`` passes through."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if name in _NAME_TO_DTYPE:
            return _NAME_TO_DTYPE[name]
        raise ValueError(f"unknown dtype {dtype!r}")
    if dtype is float:
        return float32
    if dtype is int:
        return int64
    if dtype is bool:
        return bool_
    try:
        name = np.dtype(dtype).name
    except TypeError as e:
        raise ValueError(f"unknown dtype {dtype!r}") from e
    if name in _NAME_TO_DTYPE:
        return _NAME_TO_DTYPE[name]
    raise ValueError(f"unknown dtype {dtype!r}")


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def set_default_dtype(d) -> None:
    """Default dtype for float-valued creation (reference
    paddle.set_default_dtype; float16/bfloat16/float32/float64)."""
    nd = convert_dtype(d)
    if nd not in FLOATING:
        raise TypeError(
            f"set_default_dtype only supports float dtypes, got {d!r}")
    _DEFAULT_FLOAT["value"] = nd


def get_default_dtype() -> str:
    return dtype_name(_DEFAULT_FLOAT["value"])


def default_float_dtype() -> torch.dtype:
    return _DEFAULT_FLOAT["value"]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in INTEGER or d == bool_


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in COMPLEX
