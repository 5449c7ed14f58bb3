"""The eager Tensor (counterpart of ``paddle_tpu/core/tensor.py``).

A Python wrapper over a ``torch.Tensor`` payload (``_data``), as the JAX
Tensor wraps a ``jax.Array``. It is not a ``torch.Tensor`` subclass:
Paddle's ``shape`` is a list, ``transpose(perm)`` takes a permutation and
``max(axis)`` returns values only, and a subclass would contradict
torch's own internals on all three.

The payload carries torch's autograd: ``stop_gradient`` is
``not _data.requires_grad`` (a payload of an integer or bool dtype,
which torch cannot differentiate, keeps the flag on the wrapper),
``grad`` wraps ``_data.grad`` and ``backward`` is
``torch.autograd.backward``. There is no tape of the port's own.

Mutation (in-place ops, ``__setitem__``) swaps the wrapped payload for a
new one, as the JAX Tensor does: the wrapper is the identity, the
payload a value. ``set_value`` on a tensor that requires grad (a
parameter) copies into the payload instead, so that an optimizer holding
it sees the new value. The arithmetic and method surface is attached by
``paddle_tpu_torch.ops`` at import, as in the JAX package.

While ``jit.to_static`` records a program (``capture_scope``), what the
recording cannot replay is a graph break (``GraphBreak``, the
counterpart of JAX's ``TracerBoolConversionError`` family): a host read
(``numpy``, ``item``, ``tolist``, ``bool``/``float``/``int``, ``cpu``)
and a change of payload of a tensor the program did not make
(``set_value``, ``copy_``, ``_swap_payload``, ``detach_``). The
capture decides whether the break raises (``full_graph=True``) or
marks the signature eager and lets the call go on. While ``jit.save``
exports a program (``export_scope``), a host read raises.
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional

import numpy as np
import torch

from . import dtype as dtypes
from .place import current_device, place_of

_name_counter = itertools.count()


class GraphBreak(RuntimeError):
    """What ``to_static`` records cannot hold: a host read of a traced
    value, or a change of state outside the dispatcher."""


_capture = threading.local()


def active_capture():
    """The capture recording on this thread (``jit/program.Recorder``),
    or None."""
    return getattr(_capture, "recorder", None)


class capture_scope:
    """Make ``recorder`` this thread's capture for the block (it is told
    of every graph break through ``recorder.graph_break(reason)``)."""

    def __init__(self, recorder):
        self._recorder = recorder

    def __enter__(self):
        self._prev = active_capture()
        _capture.recorder = self._recorder
        return self._recorder

    def __exit__(self, *exc):
        _capture.recorder = self._prev
        return False


def exporting() -> bool:
    """Whether ``jit.save`` is exporting a program on this thread."""
    return getattr(_capture, "exporting", False)


class export_scope:
    """Mark the block as ``jit.save``'s ``torch.export`` trace: a host
    read of a traced value raises ``GraphBreak`` naming the read, as a
    JAX export raises on a concretization."""

    def __enter__(self):
        self._prev = exporting()
        _capture.exporting = True
        return self

    def __exit__(self, *exc):
        _capture.exporting = self._prev
        return False


def graph_break(what: str) -> None:
    """Report ``what`` to the capture on this thread, if any: it raises
    ``GraphBreak`` or ends the recording. Under ``export_scope`` it
    raises."""
    if exporting():
        raise GraphBreak(f"{what} while jit.save exports a program: a "
                         f"saved program cannot read a value on the host")
    rec = active_capture()
    if rec is not None:
        rec.graph_break(f"{what} while to_static records a program")


def _differentiable(d: torch.Tensor) -> bool:
    return d.is_floating_point() or d.is_complex()


class Tensor:
    __array_priority__ = 100  # beat numpy in mixed arithmetic

    def __init__(self, data: torch.Tensor, *,
                 stop_gradient: Optional[bool] = None,
                 name: Optional[str] = None, persistable: bool = False):
        self._data = data
        rec = getattr(_capture, "recorder", None)
        if rec is not None:             # a temporary of a recorded call
            rec.note_new(self)
        self._int_stop_gradient = True
        self._grad_wrap: Optional["Tensor"] = None
        self.persistable = persistable
        self.name = name or f"generated_tensor_{next(_name_counter)}"
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def place(self):
        return place_of(self._data.device)

    @property
    def is_leaf(self) -> bool:
        return self._data.is_leaf

    def numel(self):
        return self.size

    def element_size(self):
        return self._data.element_size()

    # -------------------------------------------------------------- autograd
    @property
    def stop_gradient(self) -> bool:
        if not _differentiable(self._data):
            return self._int_stop_gradient
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        d = self._data
        if not _differentiable(d):
            self._int_stop_gradient = bool(value)
        elif value and d.requires_grad:
            if d.is_leaf:
                d.requires_grad_(False)
            else:               # cut the graph here, as Paddle does
                self._data = d.detach()
        elif not value and not d.requires_grad:
            d.requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        d = self._data
        if not (d.is_leaf or d.retains_grad) or d.grad is None:
            return None
        if self._grad_wrap is None or self._grad_wrap._data is not d.grad:
            self._grad_wrap = Tensor(d.grad)
        return self._grad_wrap

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else _payload(value)

    def clear_grad(self):
        self._data.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        if set_to_zero and self._data.grad is not None:
            self._data.grad.zero_()
        else:
            self._data.grad = None

    def retain_grads(self):
        if not self._data.is_leaf:
            self._data.retain_grad()

    def register_hook(self, hook):
        """Call ``hook(grad_tensor)`` when this tensor's gradient is
        computed; a returned Tensor replaces the gradient. Returns a
        handle with ``remove()``."""
        if self.stop_gradient:
            raise RuntimeError(
                "Cannot register hook on a tensor with stop_gradient=True")

        def on_grad(g):
            res = hook(Tensor(g))
            return None if res is None else _payload(res)
        return self._data.register_hook(on_grad)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from ..autograd import backward
        backward([self], None if grad_tensor is None else [grad_tensor],
                 retain_graph=retain_graph)

    def detach(self) -> "Tensor":
        rec = active_capture()
        if rec is not None:                 # one op of the program
            return rec.detach(self)
        return Tensor(self._data.detach(), name=self.name + ".detach")

    def detach_(self):
        return self._swap_payload(self._data.detach())

    def stop_gradient_(self, val: bool = True):
        self.stop_gradient = val
        return self

    # ------------------------------------------------------------- host reads
    def numpy(self) -> np.ndarray:
        """A host copy; bf16 comes back as float32 (numpy has no bf16)."""
        graph_break("Tensor.numpy()")
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy().copy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self, *args):
        graph_break("Tensor.item()")
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        graph_break("Tensor.tolist()")
        return self._data.tolist()

    def __float__(self):
        graph_break("float(Tensor)")
        return float(self._data.item())

    def __int__(self):
        graph_break("int(Tensor)")
        return int(self._data.item())

    def __bool__(self):
        graph_break("bool(Tensor)")
        return bool(self._data.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        if active_capture() is not None or exporting():   # no host read
            return (f"Tensor(shape={self.shape}, "
                    f"dtype={dtypes.dtype_name(self.dtype)}, "
                    f"place={self.place}{grad_info}, recorded)")
        data_str = np.array2string(self.numpy(), precision=6, separator=", ")
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtypes.dtype_name(self.dtype)}, place={self.place}"
                f"{grad_info},\n       {data_str})")

    # -------------------------------------------------------------- mutation
    def set_value(self, value):
        """Overwrite the values (Tensor.set_value): copied into the payload
        of a tensor that requires grad (a parameter keeps its identity for
        its optimizer), else a new payload."""
        d = self._data
        if active_capture() is not None:
            graph_break("Tensor.set_value()")
        v = _payload(value)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.array(value))
        v = v.to(device=d.device, dtype=d.dtype)
        if tuple(v.shape) != tuple(d.shape):
            v = v.broadcast_to(d.shape)
        if d.requires_grad and d.is_leaf:
            with torch.no_grad():
                d.copy_(v)
        else:
            self._data = v.detach().clone()
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def _swap_payload(self, new_data: torch.Tensor):
        rec = active_capture()
        if rec is not None:
            rec.note_swap(self, new_data)
        self._data = new_data
        return self

    # ------------------------------------------------------------ placement
    def cpu(self):
        graph_break("Tensor.cpu()")
        return Tensor(self._data.cpu())

    def pin_memory(self):
        return self


def _payload(x) -> torch.Tensor:
    return x._data if isinstance(x, Tensor) else x


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)


def as_tensor(data, dtype=None, stop_gradient: bool = True,
              device=None) -> Tensor:
    """to_tensor: Python/numpy/torch data on the current device (a torch
    tensor keeps its own). Float data lands as the default float dtype;
    integer data as int32, as in the JAX package (jax's x64 mode is off
    there); an explicit ``dtype`` wins."""
    d = dtypes.convert_dtype(dtype)
    if isinstance(data, Tensor):
        if d is not None and d != data.dtype:
            return Tensor(data._data.to(d), stop_gradient=stop_gradient)
        return data
    if isinstance(data, torch.Tensor):
        t = data.detach() if d is None else data.detach().to(d)
        if device is not None:
            t = t.to(device)
        return Tensor(t, stop_gradient=stop_gradient)
    probe = np.asarray(data)
    if d is None:
        if probe.dtype == np.float64:
            d = dtypes.default_float_dtype()
        elif probe.dtype == np.int64:
            d = torch.int32
        else:
            d = dtypes.convert_dtype(probe.dtype)
    dev = current_device() if device is None else torch.device(device)
    if d == torch.bfloat16:       # numpy has no bf16: go through fp32
        t = torch.tensor(probe.astype(np.float32), device=dev).to(d)
    else:
        t = torch.tensor(probe, dtype=d, device=dev)
    return Tensor(t, stop_gradient=stop_gradient)
