"""The port's op dispatcher (``core/dispatch.py``) against the JAX
package's.

Under ``auto_cast`` O1 and O2 the output dtypes of white-list, black-list
and gray ops equal the JAX dispatcher's on the same fp32/bf16 inputs
(and the values agree to the bf16 rounding, BF16_RTOL);
``FLAGS_check_nan_inf`` raises naming the op; ``stop_gradient``
propagates, also through ``differentiable_mask``; op hooks see every op;
the latency histogram counts ops under ``FLAGS_enable_metrics``.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.observability import metrics
from torch_paddle_api import assert_same, dtype_kind, jax_dtype_name
from paddle_tpu_torch.core.dtype import dtype_name

BF16_RTOL = 2 ** -7       # one bf16 rounding of the output


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _x(seed, shape=(4, 8)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


OPS = {
    # white list: inputs go to the amp dtype
    "matmul": lambda p, a, b: p.matmul(a, b, transpose_y=True),
    "linear": lambda p, a, b: p.nn.functional.linear(a, p.transpose(b, [1, 0])),
    # black list: inputs go to fp32
    "exp": lambda p, a, b: p.exp(a),
    "softmax": lambda p, a, b: p.nn.functional.softmax(a),
    "layer_norm": lambda p, a, b: p.nn.functional.layer_norm(a, 8),
    "mean": lambda p, a, b: p.mean(a, axis=1),
    "sum": lambda p, a, b: p.sum(b),
    # gray: dtypes as they come (promotion of mixed inputs)
    "add": lambda p, a, b: a + b,
    "tanh": lambda p, a, b: p.tanh(a),
    "relu": lambda p, a, b: p.nn.functional.relu(b),
}


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_amp_output_dtypes_match_jax(op, level):
    a32, b32 = _x(0), _x(1)
    outs = []
    for p in (jp, tp):
        a = p.to_tensor(a32)
        b = p.to_tensor(b32).astype("bfloat16")
        with p.amp.auto_cast(level=level, dtype="bfloat16"):
            outs.append(OPS[op](p, a, b))
    j, t = outs
    assert dtype_kind(jax_dtype_name(j.dtype)) == dtype_name(t.dtype)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy(), np.float32),
                               rtol=BF16_RTOL, atol=BF16_RTOL)


def test_amp_off_keeps_dtypes():
    a = tp.to_tensor(_x(0))
    b = tp.to_tensor(_x(1)).astype("bfloat16")
    assert (a @ tp.transpose(b, [1, 0])).dtype == tp.float32  # no cast
    assert tp.exp(b).dtype == tp.bfloat16


@pytest.mark.parametrize("p", [pytest.param(jp, id="jax"),
                               pytest.param(tp, id="port")])
def test_check_nan_inf_names_the_op(p):
    p.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = p.to_tensor([1.0, -1.0])
        p.sqrt(x * x)                             # finite: no error
        with pytest.raises(FloatingPointError, match="'log'"):
            p.log(x)
    finally:
        p.set_flags({"FLAGS_check_nan_inf": False})
    p.log(p.to_tensor([-1.0]))                    # off again


def test_stop_gradient_propagates():
    for p in (jp, tp):
        a = p.to_tensor([1.0, 2.0])
        b = p.to_tensor([3.0, 4.0], stop_gradient=False)
        assert (a * a).stop_gradient
        assert not (a * b).stop_gradient
        ids = p.to_tensor([0, 1])
        table = p.to_tensor(_x(2), stop_gradient=False)
        out = p.nn.functional.embedding(ids, table)
        assert not out.stop_gradient
        with p.no_grad():
            assert (a * b).stop_gradient


def test_differentiable_mask_detaches_the_masked_input():
    a = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    b = tp.to_tensor([3.0, 4.0], stop_gradient=False)
    out = dispatch.call("mul", lambda x, y: x * y, [a, b],
                        differentiable_mask=[True, False])
    out.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [3.0, 4.0])
    assert b.grad is None


def test_op_hooks_see_the_ops():
    seen = []

    def hook(op, ins, outs, attrs, dur):
        seen.append((op, len(ins), [o.shape for o in outs], dur >= 0))

    def legacy(op, ins, outs, attrs):
        seen.append(("legacy", op))

    dispatch.register_op_hook(hook)
    dispatch.register_op_hook(legacy)
    try:
        x = tp.to_tensor([[1.0, 2.0]])
        tp.matmul(x, x, transpose_y=True)
        tp.exp(x)
    finally:
        dispatch.unregister_op_hook(hook)
        dispatch.unregister_op_hook(legacy)
    tp.exp(tp.to_tensor([1.0]))                 # no longer seen
    assert seen == [("matmul", 2, [[1, 1]], True), ("legacy", "matmul"),
                    ("exp", 1, [[1, 2]], True), ("legacy", "exp")]


def test_metrics_count_ops_when_enabled():
    hist = metrics.REGISTRY.get("paddle_tpu_dispatch_op_latency_seconds")
    assert hist is not None

    def count():
        return hist.count(op="tanh")
    before = count()
    tp.tanh(tp.to_tensor([0.5]))
    assert count() == before                    # off: nothing recorded
    tp.set_flags({"FLAGS_enable_metrics": True})
    try:
        tp.tanh(tp.to_tensor([0.5]))
        tp.tanh(tp.to_tensor([0.5]))
    finally:
        tp.set_flags({"FLAGS_enable_metrics": False})
    assert count() == before + 2


def test_grad_of_an_amp_cast_comes_back_in_the_inputs_dtype():
    outs = []
    for p in (jp, tp):
        a = p.to_tensor(_x(0), stop_gradient=False)
        b = p.to_tensor(_x(1), stop_gradient=False)
        with p.amp.auto_cast(level="O1", dtype="bfloat16"):
            y = p.matmul(a, b, transpose_y=True)
        y.astype("float32").sum().backward()
        outs.append(a.grad)
    assert outs[1].dtype == tp.float32
    assert_same(*outs, rtol=BF16_RTOL, atol=BF16_RTOL)
