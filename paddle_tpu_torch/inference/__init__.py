"""paddle.inference — the deployment predictor and the serving engines
(counterpart of ``paddle_tpu/inference/__init__.py``).

The handle-style predictor of the reference inference API (reference:
paddle/fluid/inference/api/analysis_predictor.cc + python/paddle/inference/
— ``Config(model_file, params_file)``, ``create_predictor``,
``get_input_handle`` / ``run`` / ``get_output_handle``) over a
``jit.save`` artifact: the predictor holds a ``TranslatedLayer`` on its
device, the card unless ``Config.disable_gpu()`` asked for the CPU.
Handles hold host numpy arrays; ``run`` copies the inputs to the device
and the outputs back (the ``copy_to_cpu`` contract).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .resilience import (Overloaded, ReplicaLifecycle, ReplicaState,
                         RequestOutcome, RequestStatus, ResilienceConfig)
from .serving import (BlockManager, GPTPagedEngine, LlamaPagedEngine,
                      PagedEngine, Request)


class Config:
    """reference inference Config (model + params paths, device knobs)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # accept either the artifact prefix or explicit file names
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self.prefix = prog_file
        self.params_file = params_file
        self._device = "gpu"
        self._device_id = 0

    def set_prog_file(self, path: str):
        self.prefix = path[:-len(".pdmodel")] if path.endswith(".pdmodel") \
            else path

    def enable_use_gpu(self, memory_pool_mb: int = 100, device_id: int = 0):
        self._device, self._device_id = "gpu", device_id

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device == "gpu"

    def enable_memory_optim(self):
        pass    # the caching allocator owns buffer reuse

    def switch_ir_optim(self, flag: bool = True):
        pass    # the exported program runs as saved


class _Handle:
    """Input/output tensor handle (reference ZeroCopyTensor)."""

    def __init__(self):
        self._value: Optional[np.ndarray] = None

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.asarray(arr)

    def reshape(self, shape):
        if self._value is None:
            self._value = np.zeros(shape, np.float32)
        else:
            self._value = self._value.reshape(shape)

    def copy_to_cpu(self) -> np.ndarray:
        return self._value

    def shape(self):
        return list(self._value.shape) if self._value is not None else []


class Predictor:
    def __init__(self, config: Config):
        from ..core.place import resolve_device
        from ..jit.api import load as jit_load
        if config.prefix is None:
            raise ValueError("Config needs the saved model prefix")
        # raises without CUDA unless the config asked for the CPU
        self.device = resolve_device(
            f"cuda:{config._device_id}" if config.use_gpu() else "cpu")
        self._layer = jit_load(config.prefix, device=self.device)
        if isinstance(self._layer, dict):
            raise ValueError(
                f"{config.prefix}.pdmodel not found — jit.save the program "
                "artifact, not just parameters, for inference")
        n = int(getattr(self._layer, "n_inputs", 1))
        self._inputs: List[_Handle] = [_Handle() for _ in range(n)]
        self._outputs: List[_Handle] = []

    def get_input_names(self):
        return [f"input_{i}" for i in range(len(self._inputs))]

    def get_input_handle(self, name: str) -> _Handle:
        idx = int(name.rsplit("_", 1)[-1]) if name.rsplit(
            "_", 1)[-1].isdigit() else 0
        while len(self._inputs) <= idx:
            self._inputs.append(_Handle())
        return self._inputs[idx]

    def run(self):
        missing = [i for i, h in enumerate(self._inputs)
                   if h._value is None]
        if missing:
            raise RuntimeError(
                f"input handle(s) {missing} were never set; the model "
                f"expects {len(self._inputs)} inputs")
        args = [torch.from_numpy(np.ascontiguousarray(h._value)).to(
            self.device) for h in self._inputs]
        out = self._layer(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = []
        for o in outs:
            h = _Handle()
            h.copy_from_cpu(o.numpy())      # bf16 comes back as float32
            self._outputs.append(h)
        return True

    def get_output_names(self):
        return [f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name: str) -> _Handle:
        idx = int(name.rsplit("_", 1)[-1]) if name.rsplit(
            "_", 1)[-1].isdigit() else 0
        return self._outputs[idx]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


__all__ = ["Config", "Predictor", "create_predictor", "BlockManager",
           "Request", "PagedEngine", "LlamaPagedEngine", "GPTPagedEngine",
           "Overloaded", "ReplicaLifecycle", "ReplicaState",
           "RequestOutcome", "RequestStatus", "ResilienceConfig"]
