"""The rest of ``paddle.static`` (counterpart of
``paddle_tpu/static/tail.py``, its 36 names).

* ``append_backward``/``gradients`` ride the port's autograd: a Program
  records ops over live tensors, so reverse mode is torch's, not a pass
  over the program.
* ``save``/``load``/``load_program_state``/``set_program_state`` keep a
  program's persistable captured tensors (its parameters) in a
  ``.pdparams`` v2 file of ``framework.io``, which either package reads.
* ``save_inference_model`` exports the feed -> fetch replay (unfused)
  with ``jit.save`` (``torch.export``; attention stays the K1 op node):
  one deployment format for both captures, which ``jit.load``,
  ``load_inference_model`` and the inference ``Predictor`` load.
* a ``Scope`` holds host references: a registry.
* the IPU names raise, as the reference does where it is not built with
  IPU support.
"""
from __future__ import annotations

import contextlib
import os
import pickle
from typing import Dict, List

import numpy as np
import torch

from ..core import dispatch
from ..core.dtype import convert_dtype
from ..core.place import current_device
from ..core.tensor import Tensor, as_tensor

__all__ = [
    "append_backward", "gradients", "Scope", "global_scope",
    "scope_guard", "BuildStrategy", "ipu_shard_guard",
    "IpuCompiledProgram", "IpuStrategy", "Print", "name_scope",
    "WeightNormParamAttr", "save", "load", "save_inference_model",
    "load_inference_model", "serialize_program", "serialize_persistables",
    "save_to_file", "deserialize_program", "deserialize_persistables",
    "load_from_file", "normalize_program", "load_program_state",
    "set_program_state", "cpu_places", "cuda_places", "xpu_places",
    "Variable", "create_global_var", "create_parameter", "accuracy",
    "auc", "device_guard", "set_ipu_shard", "ctr_metric_bundle",
]

Variable = Tensor   # the reference's static Variable: a tensor handle here


# ---------------------------------------------------------------- autodiff
def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(targets)/d(inputs) (reference static/gradient.py gradients)."""
    from ..autograd import grad as _grad
    outs = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    gouts = target_gradients
    if gouts is not None and not isinstance(gouts, (list, tuple)):
        gouts = [gouts]
    return list(_grad(list(outs), list(ins), grad_outputs=gouts,
                      retain_graph=True, allow_unused=True))


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """The loss's gradients, as [(param, grad)] (reference
    base/backward.py append_backward); by default over the current
    program's captured persistable tensors that take a gradient."""
    from ..autograd import grad as _grad
    if parameter_list is None:
        from .program import default_main_program
        parameter_list = [
            v for v in default_main_program()._captured.values()
            if getattr(v, "persistable", False) and not v.stop_gradient]
    params = [p for p in parameter_list if not p.stop_gradient]
    grads = _grad(loss, params, retain_graph=True, allow_unused=True)
    return list(zip(params, grads))


# ------------------------------------------------------------------ scopes
class Scope:
    """A variable registry (reference core.Scope)."""

    def __init__(self):
        self._vars: Dict[str, object] = {}

    def var(self, name: str):
        return self._vars.setdefault(name, _ScopeVar())

    def find_var(self, name: str):
        return self._vars.get(name)

    def drop_kids(self):
        self._vars.clear()


class _ScopeVar:
    def __init__(self):
        self._value = None

    def get_tensor(self):
        return self._value

    def set_tensor(self, t):
        self._value = t


_global_scope = Scope()
_scope_stack: List[Scope] = []


def global_scope() -> Scope:
    return _scope_stack[-1] if _scope_stack else _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


# ----------------------------------------------------------------- configs
class BuildStrategy:
    """The reference's graph-build switches (BuildStrategy): held, with
    no effect on a replay."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.memory_optimize = True
        self.build_cse_optimized_program = False
        self.debug_graphviz_path = ""


class WeightNormParamAttr:
    """A ParamAttr with a weight-norm dim (reference
    WeightNormParamAttr), for ``nn.utils.weight_norm``."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        from ..nn.parameter import ParamAttr
        self.dim = dim
        self.attr = ParamAttr(name=name, initializer=initializer,
                              learning_rate=learning_rate,
                              regularizer=regularizer,
                              trainable=trainable, need_clip=need_clip)


# --------------------------------------------------------------- IPU gates
_IPU_MSG = ("Can not use {} in paddle_tpu_torch: it runs on CUDA devices "
            "(the reference raises the same way when not compiled with "
            "IPU support)")


class IpuStrategy:
    def __init__(self):
        raise RuntimeError(_IPU_MSG.format("IpuStrategy"))


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise RuntimeError(_IPU_MSG.format("IpuCompiledProgram"))


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    raise RuntimeError(_IPU_MSG.format("ipu_shard_guard"))
    yield  # pragma: no cover


def set_ipu_shard(call_func, index=-1, stage=-1):
    raise RuntimeError(_IPU_MSG.format("set_ipu_shard"))


# ------------------------------------------------------------- misc guards
@contextlib.contextmanager
def name_scope(prefix=None):
    """Name prefixes change no program; kept for the reference's API."""
    yield


@contextlib.contextmanager
def device_guard(device=None):
    """The reference's per-op device pinning: accepted, with no effect, as
    in the JAX package (a program runs on one device)."""
    yield


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Print a tensor and pass it through (reference static.Print)."""
    t = as_tensor(input)
    head = message or ""
    vals = t.numpy().reshape(-1)[:summarize]
    print(f"{head} {t.name if print_tensor_name else ''} "
          f"shape={list(t.shape) if print_tensor_shape else ''} "
          f"values={vals}")
    return t


# ------------------------------------------------------------ vars/params
def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    return Tensor(torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                             device=current_device()),
                  name=name, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    from ..nn.parameter import create_parameter as _cp
    if attr is None and name is not None:
        attr = name
    return _cp(shape, dtype=dtype, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


# ----------------------------------------------------------------- metrics
def accuracy(input, label, k=1, correct=None, total=None, name=None):
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


def _auc_in_graph(num_thresholds: int):
    """A batch's ROC AUC from the thresholded bins of
    ``metric.Auc.update``/``accumulate`` (shapes fixed by
    ``num_thresholds``), as device ops."""

    def f(pred, lab):
        if pred.dim() == 2 and pred.shape[1] == 2:      # (N, 2) probas
            pred = pred[:, 1]
        pred = pred.reshape(-1).float()
        # label truthiness, as the accumulator's labels.astype(bool)
        posf = (lab.reshape(-1) != 0).float()
        bins = (pred * num_thresholds).to(torch.int32).clamp(
            0, num_thresholds).long()
        stat_pos = torch.zeros(num_thresholds + 1, device=pred.device
                               ).index_add(0, bins, posf)
        stat_neg = torch.zeros(num_thresholds + 1, device=pred.device
                               ).index_add(0, bins, 1.0 - posf)
        tot_pos, tot_neg = stat_pos.sum(), stat_neg.sum()
        zero = torch.zeros(1, device=pred.device)
        # TPR over FPR from the highest threshold down, from (0, 0)
        pos = torch.cat([zero, torch.cumsum(stat_pos.flip(0), 0)])
        neg = torch.cat([zero, torch.cumsum(stat_neg.flip(0), 0)])
        tpr = pos / tot_pos.clamp(min=1.0)
        fpr = neg / tot_neg.clamp(min=1.0)
        area = torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) * 0.5)
        # a one-class batch scores 0.0, as the accumulator does
        return torch.where((tot_pos > 0) & (tot_neg > 0), area,
                           torch.zeros_like(area))
    return f


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    """A batch's AUC, one op on the device (the reference's static.auc
    returns (auc, batch_auc, state); here the batch value twice and an
    empty state)."""
    val = dispatch.call("auc", _auc_in_graph(num_thresholds),
                        [as_tensor(input), as_tensor(label)],
                        differentiable_mask=[False, False])
    return val, val, ()


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """The CTR metrics (reference ctr_metric_bundle): (auc, sqrerr,
    abserr, prob, q, pos, total), reductions on the device."""
    a, _, _ = auc(input, label)

    def f(p, y):
        pred, lab = p.reshape(-1).float(), y.reshape(-1).float()
        s = torch.sum(pred)
        return (torch.sum((pred - lab) ** 2), torch.sum((pred - lab).abs()),
                s, s.clone(), torch.sum(lab),
                torch.tensor(float(pred.shape[0]), device=pred.device))
    rest = dispatch.call("ctr_metric_bundle", f,
                         [as_tensor(input), as_tensor(label)],
                         differentiable_mask=[False, False])
    return (a, *rest)


# --------------------------------------------------------------- save/load
def _program_params(program) -> Dict[str, Tensor]:
    """The program's persistable captured tensors by name, in recording
    order (an unnamed one as ``var_<i>``)."""
    out = {}
    for i, v in enumerate(program._captured.values()):
        if isinstance(v, Tensor) and getattr(v, "persistable", False):
            out[v.name or f"var_{i}"] = v
    return out


def _assign(t: Tensor, value) -> None:
    """``t`` takes ``value`` (a Tensor or an array) in its own dtype and
    device; a parameter keeps its payload."""
    v = value._data if isinstance(value, Tensor) else torch.as_tensor(
        np.asarray(value))
    t.set_value(v)


def save(program, model_path, protocol=4, **configs):
    """Write the program's persistable tensors to ``model_path +
    ".pdparams"`` (reference static.save)."""
    from ..framework.io import save as _save
    _save(dict(_program_params(program)), model_path + ".pdparams",
          protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    """Read back what ``save`` wrote into the program's tensors."""
    from ..framework.io import load as _load
    state = _load(model_path + ".pdparams")
    params = _program_params(program)
    for k, v in state.items():
        if k in params:
            _assign(params[k], v)


def load_program_state(model_path, var_list=None):
    from ..framework.io import load as _load
    state = _load(model_path + ".pdparams")
    return {k: (v.numpy() if isinstance(v, Tensor) else np.asarray(v))
            for k, v in state.items()}


def set_program_state(program, state_dict):
    params = _program_params(program)
    for k, v in state_dict.items():
        if k in params:
            _assign(params[k], v)


def normalize_program(program, feeds, fetches, **kwargs):
    """The feed -> fetch slice (reference normalize_program): a run
    replays exactly the steps its fetches need, so the program and its
    ends are the normalized form."""
    return {"program": program, "feeds": list(feeds),
            "fetches": list(fetches)}


class _ProgramLayer:
    """A program's feed -> fetch replay as what ``jit.save`` exports: its
    ``forward`` on the feed Tensors, its captured tensors as the state
    (the persistable ones as parameters, the rest as buffers)."""

    training = False

    def __init__(self, program, feed_vars, fetch_vars):
        self._replay = program._replay_fn(feed_vars, fetch_vars)
        params = _program_params(program)
        taken = {id(t) for t in params.values()}
        buffers = {}
        for t in program._captured.values():
            if id(t) not in taken:
                name = t.name
                while name in params or name in buffers:
                    name += "_"
                buffers[name] = t
        self._params, self._buffers = params, buffers

    def forward(self, *xs):
        outs = self._replay(*xs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    __call__ = forward

    def state_dict(self):
        return {**self._params, **self._buffers}

    def named_parameters(self):
        return list(self._params.items())

    def named_buffers(self):
        return list(self._buffers.items())


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Export the feed -> fetch computation as a ``jit.save`` artifact
    (``.pdmodel`` + ``.pdparams``; reference save_inference_model) at the
    feeds' build shapes."""
    from ..jit.api import save as _jit_save
    from . import InputSpec
    from .program import default_main_program

    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    program = program or default_main_program()
    spec = [InputSpec.from_tensor(v) for v in feed_vars]
    _jit_save(_ProgramLayer(program, feed_vars, fetch_vars), path_prefix,
              input_spec=spec)
    return path_prefix


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Load an exported artifact: [the callable program, feed names, fetch
    names], the JAX package's triple."""
    from ..jit.api import load as _jit_load
    layer = _jit_load(path_prefix)
    n = getattr(layer, "n_inputs", 1)
    return [layer, [f"x{i}" for i in range(n)], ["out"]]


# ------------------------------------------------- serialization helpers
def serialize_program(feed_vars, fetch_vars, program=None, **kwargs):
    from .program import default_main_program
    program = program or default_main_program()
    return pickle.dumps({"ops": [r.name for r in
                                 program.global_block().ops],
                         "n_feeds": len(list(feed_vars)),
                         "n_fetches": len(list(fetch_vars))})


def serialize_persistables(feed_vars, fetch_vars, program=None, **kwargs):
    from .program import default_main_program
    program = program or default_main_program()
    return pickle.dumps({k: v.numpy()
                         for k, v in _program_params(program).items()})


def deserialize_program(data: bytes):
    return pickle.loads(data)


def deserialize_persistables(program, data: bytes, executor=None):
    set_program_state(program, pickle.loads(data))


def save_to_file(path, content: bytes):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------------ places
def cpu_places(device_count=None):
    from ..core.place import CPUPlace
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """The CUDA devices' places (all of them by default)."""
    from ..core.place import CUDAPlace
    ids = device_ids if device_ids is not None else range(
        torch.cuda.device_count())
    return [CUDAPlace(int(i)) for i in ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)
