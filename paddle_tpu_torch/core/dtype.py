"""Dtype names <-> ``torch.dtype`` (counterpart of ``paddle_tpu/core/dtype.py``).

Only the types the serving slice uses are mapped; Paddle-style aliases
(``fp32``, ``bf16``, ...) are accepted as in the JAX package.
"""
from __future__ import annotations

from typing import Union

import torch

_NAME_TO_DTYPE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
}
_DTYPE_TO_NAME = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.int32: "int32",
    torch.int64: "int64",
}


def convert_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A dtype name (``"bfloat16"``, ``"paddle.float32"``, ``"bf16"``) or a
    ``torch.dtype`` -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPE_TO_NAME:
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    if isinstance(dtype, str):
        name = dtype.lower().replace("paddle.", "")
        if name in _NAME_TO_DTYPE:
            return _NAME_TO_DTYPE[name]
    raise ValueError(f"unknown dtype {dtype!r}")


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    return _DTYPE_TO_NAME[convert_dtype(dtype)]
