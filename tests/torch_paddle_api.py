"""Shared helpers of the Paddle-API parity tests: run one function on
both packages and compare.

``paddle_tpu`` runs with jax's x64 mode off, so its int64 requests give
int32; dtypes are compared by kind for integers (``dtype_kind``) and by
name otherwise.
"""
import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core.dtype import dtype_name as jax_dtype_name
from paddle_tpu_torch.core.dtype import dtype_name as port_dtype_name


def dtype_kind(name: str) -> str:
    return "int" if name.startswith(("int", "uint")) else name


def assert_same(jax_out, port_out, rtol=1e-5, atol=1e-6):
    """Values within the tolerances, the same shapes, the same dtypes
    (by kind for integers)."""
    js = jax_out if isinstance(jax_out, (list, tuple)) else [jax_out]
    ts = port_out if isinstance(port_out, (list, tuple)) else [port_out]
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        assert list(j.shape) == list(t.shape)
        assert dtype_kind(jax_dtype_name(j.dtype)) == dtype_kind(
            port_dtype_name(t.dtype))
        np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()),
                                   rtol=rtol, atol=atol)


def run_both(fn, *arrays, stop_gradient=True):
    """``fn(package, *tensors)`` on each package over the same numpy
    arrays; returns (jax result, port result, jax inputs, port inputs)."""
    jts = [jp.to_tensor(a, stop_gradient=stop_gradient) for a in arrays]
    tts = [tp.to_tensor(a, stop_gradient=stop_gradient) for a in arrays]
    return fn(jp, *jts), fn(tp, *tts), jts, tts


def assert_grads(jax_layer, port_layer, rtol, key_bias_rel=1e-3):
    """Every parameter's gradient, norm-wise to ``rtol``, in the order of
    ``named_parameters`` (the same in both packages). A key projection's
    bias has a zero gradient in exact arithmetic (it shifts a row's
    logits by one constant): both packages hold rounding noise there, so
    it is held below ``key_bias_rel`` of the largest gradient norm."""
    pairs = list(zip(jax_layer.named_parameters(), port_layer.parameters()))
    largest = max(np.linalg.norm(np.asarray(j.grad.numpy()))
                  for (_, j), _ in pairs if j.grad is not None)
    for (name, j), t in pairs:
        if j.grad is None or t.grad is None:        # an unused parameter
            assert j.grad is None and t.grad is None, name
            continue
        g_j = np.asarray(j.grad.numpy(), np.float64)
        g_t = t.grad.numpy().astype(np.float64)
        if name.endswith("k_proj.bias"):
            assert max(np.abs(g_j).max(), np.abs(g_t).max()) \
                <= key_bias_rel * largest, name
            continue
        err = np.linalg.norm(g_t - g_j) / max(np.linalg.norm(g_j), 1e-30)
        assert err <= rtol, (name, err)
