"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside ``paddle_tpu`` (the JAX reference, which it
never imports). It works on ``torch.Tensor`` directly. Every TPU kernel
on a ported path is a kernel written by hand for Hopper under
``csrc/``, built at first use; entry points run on the card unless the
caller passes ``device="cpu"``.

Ported so far: GPT-2 inference through the flash-attention forward
kernel, serving of GPT-2 and LLaMA over paged KV caches (``PagedEngine``:
per-request sampling, int8 KV pages, the phase-split scheduler and n-gram
speculative decoding, ``serving``), and GPT-2
training (cross entropy, AdamW with gradient clipping and LR schedules)
through the forward and backward flash-attention kernels; LLaMA, and
``jit.to_static`` whose graph-fusion pass (``FLAGS_enable_fusion``)
rewrites training onto the fused kernels (residual + norm, bias +
activation, norm + matmul + activation, matmul + rope); amp (O1
``auto_cast``, O2 ``decorate``, ``GradScaler``), the fused chunked
LM-head loss, block recompute (``distributed.fleet.recompute``) and
bf16/int8 Adam moments; the serving tier's front end: the replica
lifecycle, deadlines and backpressure (``inference.resilience``),
request tracing and metrics (``observability``), ``serving.Router``,
``serving.TokenStream`` and the open-loop load harness
(``tools.loadgen``).

The Paddle API's eager core, as in the JAX package: ``Tensor`` over a
``torch.Tensor`` payload with torch's autograd, the op dispatcher
(``core.dispatch``: amp casts, NaN/Inf checks, op hooks, metrics), the
ops, ``autograd`` (``backward``, ``grad``, ``PyLayer``, jacobian and
hessian), ``nn.Layer`` and its layers, and BERT written on them:
``import paddle_tpu_torch as paddle``, then ``paddle.to_tensor``,
``paddle.nn.Linear``, ``loss.backward()`` and
``paddle.optimizer.AdamW(parameters=layer.parameters())``. Tensors land
on the card unless ``paddle.set_device("cpu")`` asked for the CPU.

Image classification on that core: the convolutions and pools
(``nn.Conv2D``, ``nn.MaxPool2D``, ...), ``vision.models`` (the ResNet
family), ``io`` (datasets, samplers, ``DataLoader``, the
``DevicePrefetcher``), ``metric``, and ``hapi``'s ``Model.fit`` /
``evaluate`` / ``predict`` with its callbacks, the goodput ledger and
the sentinel.

Checkpoints and resume: ``paddle.save``/``paddle.load`` (``framework``:
the JAX package's v2 files, atomic and verified, which either package
reads), ``fault.CheckpointManager`` with ``auto_resume``,
``hapi.ModelCheckpoint``, ``Model.save``/``load``/``summary`` and
``fit(resume=...)``, ``paddle.summary`` and ``paddle.flops``, and the
rest of the JAX package's ``optimizer.py`` (``Momentum``, ``Adagrad``,
``RMSProp``, ``Adadelta``, ``Adamax``, ``Lamb``, ``NAdam``, ``RAdam``).

Deployment: ``jit.save``/``jit.load`` (a ``torch.export`` program that
holds the K1 attention op as a node, beside its ``.pdparams``) and
``jit.TranslatedLayer``, ``TracedLayer.save_inference_model``, the
handle-style ``inference.Config``/``create_predictor``, int8
``quantization`` (``PTQ``, ``QAT``, weight-only and LLM.int8 linears)
and ``onnx.export`` with its bundled numpy evaluator.
"""
from . import (amp, autograd, compile, core, distributed, fault, framework,
               hapi, incubate, inference, io, jit, metric, models, nn,
               observability, onnx, ops, optimizer, quantization, serving,
               static, tools, vision)
from .autograd import PyLayer, backward, grad, is_grad_enabled
from .core import get_flag, resolve_device, set_flags
from .core.dispatch import (enable_grad, no_grad,
                            set_grad_enabled_ctx as set_grad_enabled)
from .core.dtype import (bfloat16, bool_ as bool, complex64, complex128,
                         float16, float32, float64, get_default_dtype, int8,
                         int16, int32, int64, set_default_dtype, uint8)
from .core.generator import get_rng_state, seed, set_rng_state
from .core.place import (CPUPlace, CUDAPlace, Place, device_count,
                         device_guard, get_device, set_device)
from .core.tensor import Tensor, is_tensor
from .nn.parameter import ParamAttr, create_parameter
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops
from .framework import load, save
from .hapi import Model, flops, summary
from .inference import GPTPagedEngine, LlamaPagedEngine, PagedEngine
from .jit import to_static
from .models import (GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM,
                     gpt2_medium, gpt2_small)

__all__ = ["amp", "autograd", "compile", "core", "distributed", "fault",
           "framework", "save", "load", "summary", "flops", "hapi", "incubate", "inference", "io", "jit", "metric", "models",
           "nn", "observability", "onnx", "ops", "optimizer", "quantization",
           "serving", "static", "tools",
           "vision", "Model", "resolve_device",
           "Tensor", "is_tensor", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "backward", "grad",
           "PyLayer", "seed", "get_rng_state", "set_rng_state",
           "set_device", "get_device", "device_guard", "device_count",
           "Place", "CPUPlace", "CUDAPlace", "ParamAttr", "create_parameter",
           "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "get_default_dtype", "set_default_dtype", "get_flag", "set_flags", "to_static", "GPTConfig", "GPTForCausalLM",
           "gpt2_small", "gpt2_medium", "LlamaConfig", "LlamaForCausalLM",
           "PagedEngine", "GPTPagedEngine", "LlamaPagedEngine"] + list(_ops)
