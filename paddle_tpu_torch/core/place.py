"""Device resolution and places for the PyTorch port.

Counterpart of ``paddle_tpu/core/place.py``. The port works on
``torch.device`` directly; this module fixes the rule every entry point
follows: run on the card unless the caller asks for the CPU. A missing
card is an error, never a silent move to the CPU.

``set_device``/``get_device`` hold the Paddle API's process-wide device
(``set_device("cpu")`` is how a caller asks the Paddle-API entry points
for the CPU); with none set, ``current_device()`` is ``cuda:0``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, int, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cuda"`` or ``"gpu"`` -> ``cuda:0``;
    ``"cpu"`` -> CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and CUDA is not available.
    """
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda[:i]' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0 if dev.index is None else dev.index)


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        return resolve_device("cpu" if self.device_type == "cpu"
                              else f"cuda:{self.device_id}")


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    device_type = "gpu"


_current: Optional[str] = None


def set_device(device: str) -> Place:
    """Make ``device`` (``"cpu"``, ``"gpu"``, ``"gpu:i"``, ``"cuda:i"``) the
    Paddle API's device for this process. A card is checked for here."""
    global _current
    dev = resolve_device(device)
    _current = "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"
    return place_of(dev)


def get_device() -> str:
    """``"cpu"`` or ``"gpu:i"``: the device ``set_device`` chose, else
    ``"gpu:0"``."""
    return _current if _current is not None else "gpu:0"


@contextlib.contextmanager
def device_guard(device: str):
    """Run a block with ``set_device(device)``; the previous device (or
    none) is restored after it."""
    global _current
    prev = _current
    set_device(device)
    try:
        yield
    finally:
        _current = prev


def current_device() -> torch.device:
    """The ``torch.device`` the Paddle API creates tensors on; raises when
    no device was set and CUDA is not available."""
    return resolve_device(None if _current is None else _current)


def place_of(dev: torch.device) -> Place:
    return CPUPlace(0) if dev.type == "cpu" else CUDAPlace(dev.index or 0)


def device_count() -> int:
    return torch.cuda.device_count()
