"""Device resolution for the PyTorch port.

Counterpart of ``paddle_tpu/core/place.py``. The port works on
``torch.device`` directly; this module only fixes the rule every entry
point follows: run on the card unless the caller asks for the CPU. A
missing card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, int, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cuda"`` -> ``cuda:0``; ``"cpu"`` -> CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and CUDA is not available.
    """
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda[:i]' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0 if dev.index is None else dev.index)
