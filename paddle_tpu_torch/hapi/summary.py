"""paddle.summary: the layer and parameter table (counterpart of
``paddle_tpu/hapi/summary.py``, the JAX package's code)."""
from __future__ import annotations

import numpy as np

from ..core.tensor import Tensor


def summary(net, input_size=None, dtypes=None, input=None):
    """Run a forward pass with hooks to collect per-layer output shapes and
    parameter counts; returns {'total_params': N, 'trainable_params': N}."""
    from ..ops.creation import to_tensor

    rows = []
    hooks = []

    def make_hook(name):
        def hook(layer, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            shape = list(out.shape) if isinstance(out, Tensor) else None
            n_params = sum(int(np.prod(p.shape))
                           for p in layer.parameters(
                               include_sublayers=False))
            rows.append((name, type(layer).__name__, shape, n_params))
        return hook

    for name, layer in net.named_sublayers():
        hooks.append(layer.register_forward_post_hook(make_hook(name)))

    was_training = net.training
    try:
        if input is not None:
            x = input
        else:
            if input_size is None:
                raise ValueError("summary needs input_size or input")
            sizes = input_size if isinstance(input_size, (list, tuple)) and \
                isinstance(input_size[0], (list, tuple)) else [input_size]
            dts = dtypes if dtypes else ["float32"] * len(sizes)
            x = [to_tensor(
                np.zeros([d if d and d > 0 else 1 for d in s],
                         np.dtype(dt) if dt != "bfloat16" else np.float32))
                for s, dt in zip(sizes, dts)]
            x = x[0] if len(x) == 1 else x
        net.eval()
        net(*x) if isinstance(x, list) else net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if not p.stop_gradient)
    line = "-" * 72
    print(line)
    print(f"{'Layer (type)':<34}{'Output Shape':<24}{'Param #':<12}")
    print(line)
    for name, cls, shape, n in rows:
        print(f"{name + ' (' + cls + ')':<34}{str(shape):<24}{n:<12}")
    print(line)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}
