"""Performance attribution on the card (counterpart of
``paddle_tpu/observability/perf``).

- :mod:`.costmodel`: analytical per-op-class FLOPs/bytes formulas
  attached to the op registry (``OpDef.cost_fn``), cross-checkable
  against ``torch.utils.flop_counter.FlopCounterMode`` (``counted_cost``,
  the port's counterpart of the JAX package's ``xla_cost``).
- :mod:`.device`: timed sections that synchronize the card, the
  analysis of each program ``to_static`` records and each SOT segment
  plan (``FLAGS_perf_capture``), and the step-time attribution that
  splits each step into compute / collective / host / idle.
- :mod:`.memory`: the live-memory census attributed as params / grads /
  optimizer state / KV cache / activations through holder providers,
  with per-phase high-water marks (``paddle_tpu_hbm_*`` metrics).

The reporting rides in ``tools/perf_report.py``.

The peak tables below are keyed by a prefix of
``torch.cuda.get_device_name()``. Their entries come from NVIDIA's H100
Tensor Core GPU datasheet: H100 SXM5 80 GB, 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 80 GB; H100 PCIe 80 GB, 756 TFLOP/s dense bf16, 2.0 TB/s
HBM2e, 80 GB. A card the tables do not name raises; without CUDA (or
for a CPU device) the CPU fallbacks keep the roofline math finite.
"""
from __future__ import annotations

from . import costmodel, device, memory
from .costmodel import (OpCost, attach_cost_models, collective_cost,
                        cost_of, counted_cost)
from .device import (analyze, attribute, capture_enabled, compiled_programs,
                     measure, record_compiled, step_attribution,
                     timed_section)
from .memory import census, high_water, update_high_water

__all__ = ["costmodel", "device", "memory", "OpCost", "cost_of",
           "attach_cost_models", "collective_cost", "counted_cost",
           "analyze", "attribute", "capture_enabled", "compiled_programs",
           "measure", "record_compiled", "step_attribution",
           "timed_section", "census", "high_water", "update_high_water",
           "PEAK_FLOPS", "PEAK_HBM_BW", "HBM_CAPACITY", "chip_peak_flops",
           "chip_peak_bw", "chip_hbm_bytes"]

#: peak dense bf16 FLOP/s of one card (NVIDIA H100 datasheet), keyed by a
#: prefix of ``torch.cuda.get_device_name()``: the roofline's compute
#: ceiling
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,      # H100 SXM5
    "NVIDIA H100 PCIe": 756e12,
}

#: peak HBM bytes/s of one card (the same datasheet): the roofline's
#: second ceiling
PEAK_HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}

#: HBM capacity in bytes of one card (the same datasheet)
HBM_CAPACITY = {
    "NVIDIA H100 80GB HBM3": 80e9,
    "NVIDIA H100 PCIe": 80e9,
}


def _chip_lookup(table, device_obj, cpu_default) -> float:
    import torch

    dev = None
    if device_obj is not None:
        dev = torch.device(device_obj) if not isinstance(
            device_obj, torch.device) else device_obj
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is None or dev.type != "cuda":
        return cpu_default
    kind = torch.cuda.get_device_name(dev)
    for name, v in table.items():
        if kind.lower().startswith(name.lower()):
            return v
    raise ValueError(f"observability.perf: no datasheet entry for the card "
                     f"{kind!r}; the tables name {sorted(table)}")


def chip_peak_flops(device_obj=None) -> float:
    """Peak dense bf16 FLOP/s of the card (CPU fallback 1 TF/s, so the
    MFU math stays finite on hosts without a card)."""
    return _chip_lookup(PEAK_FLOPS, device_obj, 1e12)


def chip_peak_bw(device_obj=None) -> float:
    """Peak HBM bytes/s of the card (CPU fallback 100 GB/s)."""
    return _chip_lookup(PEAK_HBM_BW, device_obj, 100e9)


def chip_hbm_bytes(device_obj=None) -> float:
    """HBM capacity in bytes of one card (CPU fallback 16 GB)."""
    return _chip_lookup(HBM_CAPACITY, device_obj, 16e9)
