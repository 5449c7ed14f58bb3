"""Layer: the module base class (counterpart of
``paddle_tpu/nn/layer/layers.py``).

A Python class, not a ``torch.nn.Module``: Paddle's ``parameters()``,
``state_dict()``, ``set_state_dict()`` and ``to()`` take and return
Paddle Tensors in Paddle's layouts (a ``Linear`` weight is (in, out)),
and ``torch.nn.Module``'s methods of the same names would contradict
them. Parameters are ``Parameter``s over leaf ``torch.Tensor``s; the
state dict's keys and layouts are the JAX package's, so
``set_state_dict`` of the JAX model's numpy state carries every weight
across (``models/convert.py`` ``load_jax_layer_state``). ``to`` casts and
moves the payloads; ``copy.deepcopy`` of a Layer deep-copies them.
A layer built under ``LazyGuard`` initializes its parameters at its
first call (``nn/lazy_init.py``).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, Optional, Tuple

from ...core import dtype as dtypes
from ...core.tensor import Tensor
from ..lazy_init import has_outstanding, materialize_layer
from ..parameter import Parameter, create_parameter


class _HookRemoveHelper:
    def __init__(self, hooks: dict, hook_id: int):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self.training = True
        self._dtype = dtypes.convert_dtype(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()
        self._parameters: Dict[str, Optional[Parameter]] = collections.OrderedDict()
        self._sub_layers: Dict[str, Optional["Layer"]] = collections.OrderedDict()
        self._buffers: Dict[str, Optional[Tensor]] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks: Dict[int, Callable] = collections.OrderedDict()
        self._forward_post_hooks: Dict[int, Callable] = collections.OrderedDict()
        self._hook_id = 0
        self._casted_by_pure_fp16 = False

    # ------------------------------------------------------------ attributes
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning parameters")
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            params[name] = value
            object.__getattribute__(self, "__dict__").pop(name, None)
            return
        if isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning sublayers")
            for d in (params, buffers):
                if d is not None:
                    d.pop(name, None)
            layers[name] = value
            object.__getattribute__(self, "__dict__").pop(name, None)
            return
        if params is not None and name in params:
            if value is None:
                params[name] = None
                return
            if isinstance(value, Tensor):
                params[name].set_value(value)
                return
            params.pop(name)
        if layers is not None and name in layers and value is None:
            layers[name] = None
            return
        if buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
                return
            buffers.pop(name)
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        d = self.__dict__
        for store in ("_parameters", "_sub_layers", "_buffers"):
            s = d.get(store)
            if s is not None and name in s:
                return s[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute {name!r}")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            s = self.__dict__.get(store)
            if s is not None and name in s:
                del s[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extra = []
        for store in ("_parameters", "_sub_layers", "_buffers"):
            extra += list(self.__dict__.get(store, ()))
        return list(super().__dir__()) + extra

    # ------------------------------------------------------------- creation
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Optional[Parameter]:
        dtype = dtype or self._dtype
        return create_parameter(shape, dtype=dtype, attr=attr, is_bias=is_bias,
                                default_initializer=default_initializer)

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[Tensor],
                        persistable: bool = True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ------------------------------------------------------------ iteration
    def parameters(self, include_sublayers: bool = True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True
                         ) -> Iterator[Tuple[str, Parameter]]:
        seen = set()
        for layer_name, layer in self.named_sublayers(prefix=prefix,
                                                      include_self=True):
            if not include_sublayers and layer is not self:
                continue
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (layer_name + "." + pname if layer_name else pname), p

    def buffers(self, include_sublayers: bool = True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True):
        seen = set()
        for layer_name, layer in self.named_sublayers(prefix=prefix,
                                                      include_self=True):
            if not include_sublayers and layer is not self:
                continue
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (layer_name + "." + bname if layer_name else bname), b

    def children(self) -> Iterator["Layer"]:
        for _, l in self.named_children():
            yield l

    def named_children(self):
        for name, l in self._sub_layers.items():
            if l is not None:
                yield name, l

    def sublayers(self, include_self: bool = False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None):
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, l in self._sub_layers.items():
            if l is None:
                continue
            sub_prefix = prefix + "." + name if prefix else name
            yield from l.named_sublayers(prefix=sub_prefix, include_self=True,
                                         layers_set=layers_set)

    def apply(self, fn):
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    def full_name(self):
        return self._name_scope

    # ------------------------------------------------------------ training
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    # ----------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True):
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters(prefix=structured_name_prefix.rstrip(".")):
            dest[name] = p
        for name, b in self.named_buffers(prefix=structured_name_prefix.rstrip(".")):
            bare = name.rsplit(".", 1)[-1]
            owner = self._locate_owner(name)
            if owner is not None and bare in owner._non_persistable_buffer_names:
                continue
            dest[name] = b
        return dest

    def _locate_owner(self, qualified: str) -> Optional["Layer"]:
        parts = qualified.split(".")[:-1]
        layer = self
        for p in parts:
            nxt = layer._sub_layers.get(p)
            if nxt is None:
                return None
            layer = nxt
        return layer

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        missing, unexpected = [], []
        own = self.state_dict()
        matched = set()
        for name, value in state_dict.items():
            if name not in own:
                unexpected.append(name)
                continue
            target = own[name]
            v = value._data if isinstance(value, Tensor) else value
            if tuple(v.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: got {tuple(v.shape)}, "
                    f"expected {tuple(target.shape)}")
            target.set_value(v)
            matched.add(name)
        for name in own:
            if name not in matched:
                missing.append(name)
        return missing, unexpected

    load_dict = set_state_dict

    # ------------------------------------------------------------------ cast
    def _apply_to_tensors(self, fn):
        for layer in self.sublayers(include_self=True):
            for k, p in layer._parameters.items():
                if p is not None:
                    fn(p)
            for k, b in layer._buffers.items():
                if b is not None:
                    fn(b)
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Cast the floating parameters and buffers to ``dtype`` and/or
        move every one to ``device``: each gets a new leaf payload with
        the same ``stop_gradient``."""
        if device is None and dtype is None:
            return self
        target = dtypes.convert_dtype(dtype)
        dev = None
        if device is not None:
            from ...core.place import resolve_device
            dev = (device.torch_device() if hasattr(device, "torch_device")
                   else resolve_device(device))

        def move(t):
            d = t._data
            cast = target if (target is not None and d.is_floating_point()
                              and d.dtype != target) else None
            if cast is None and (dev is None or d.device == dev):
                return
            new = d.detach().to(device=dev, dtype=cast)
            t._swap_payload(new.requires_grad_(d.requires_grad))
        self._apply_to_tensors(move)
        if target is not None:
            self._dtype = target
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=dtypes.float32)

    def bfloat16(self):
        return self.to(dtype=dtypes.bfloat16)

    def float16(self):
        return self.to(dtype=dtypes.float16)

    # ---------------------------------------------------------------- hooks
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return _HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return _HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # ----------------------------------------------------------------- call
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        if has_outstanding():       # LazyGuard's parameters: initialize now
            materialize_layer(self)
        for hook in list(self._forward_pre_hooks.values()):
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    # ---------------------------------------------------------------- extra
    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, l in self._sub_layers.items():
            if l is None:
                continue
            mod_str = repr(l)
            mod_str = "\n".join(
                ("  " + ln if i else ln) for i, ln in enumerate(mod_str.split("\n")))
            lines.append(f"({name}): {mod_str}")
        main = self.__class__.__name__
        if not lines:
            return f"{main}({extra})"
        body = "\n  ".join([extra] if extra else []) + ("\n  " if extra and lines else "")
        return f"{main}(\n  " + "\n  ".join(([extra] if extra else []) + lines) + "\n)"
