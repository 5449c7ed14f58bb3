"""The port's ONNX export (``onnx.export``, the dispatcher's export hook,
the bundled protobuf writer and numpy evaluator) against the JAX
package's: the cases of ``tests/test_onnx_export.py`` and
``tests/test_text_onnx.py::test_onnx_export_requires_input_spec``.

Each model is built in both packages with the same numpy weights and
exported by both. The two files hold the same node op types in the same
order and the same initializer shapes, and the port's file, run by the
port's evaluator, reproduces the JAX model's logits within 1e-5 (and
the port's own model's).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.onnx as jonnx
import paddle_tpu_torch as tp
import paddle_tpu_torch.onnx as tonnx
from paddle_tpu_torch.models import load_jax_layer_state

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def seeded_state(layer, seed):
    """numpy weights for a JAX layer's state dict: batch-norm statistics
    and gains near their defaults, the rest scaled by fan-in."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in layer.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("_variance"):
            arr = 1.0 + 0.1 * np.abs(rng.randn(*shape))
        elif k.endswith("_mean") or k.endswith("bias"):
            arr = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            arr = 1.0 + 0.1 * rng.randn(*shape)
        else:
            arr = rng.randn(*shape) / np.sqrt(np.prod(shape[1:])
                                              if len(shape) == 4
                                              else shape[0])
        out[k] = arr.astype(np.float32)
    return out


def pair(build, seed):
    """(JAX model, port model) from ``build(pkg)``, the same weights."""
    jm, tm = build(jp), build(tp)
    state = seeded_state(jm, seed)
    jm.set_state_dict(state)
    load_jax_layer_state(tm, state)
    jm.eval()
    tm.eval()
    return jm, tm


def structure(path, parse):
    with open(path, "rb") as f:
        model = parse(f.read())
    g = model["graph"]
    return ([n["op_type"] for n in g["nodes"]],
            sorted(tuple(np.asarray(a).shape)
                   for a in g["initializers"].values()), model)


def export_both(build, x, tmp_path, name, seed=0):
    """Export both packages' models; check the files' structures agree and
    the port's evaluator against the JAX model. Returns the port's path
    and its node op types."""
    jm, tm = pair(build, seed)
    jpath = jonnx.export(jm, str(tmp_path / f"{name}_jax"),
                         input_spec=[jp.to_tensor(x)])
    tpath = tonnx.export(tm, str(tmp_path / f"{name}_port"),
                         input_spec=[tp.to_tensor(x)])
    j_ops, j_inits, _ = structure(jpath, jonnx.proto.parse_model)
    t_ops, t_inits, model = structure(tpath, tonnx.proto.parse_model)
    assert t_ops == j_ops
    assert t_inits == j_inits
    assert model["opset"] == 13
    got = tonnx.run(tpath, {"x0": x})
    want = jm(jp.to_tensor(x))
    own = tm(tp.to_tensor(x))
    want = want if isinstance(want, (list, tuple)) else [want]
    own = own if isinstance(own, (list, tuple)) else [own]
    for g, w, o in zip(got, want, own):
        np.testing.assert_allclose(g, np.asarray(w.numpy()), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(g, o.numpy(), atol=ATOL, rtol=ATOL)
    return tpath, t_ops


def lenet(pkg):
    return pkg.vision.models.LeNet()


def test_lenet_logits_match(tmp_path):
    x = np.random.RandomState(0).randn(2, 1, 28, 28).astype(np.float32)
    _, ops = export_both(lenet, x, tmp_path, "lenet")
    assert "Conv" in ops and "MaxPool" in ops and "Gemm" in ops


def test_onnxruntime_if_available(tmp_path):
    ort = pytest.importorskip("onnxruntime")
    _, tm = pair(lenet, 1)
    x = np.random.RandomState(1).randn(1, 1, 28, 28).astype(np.float32)
    path = tonnx.export(tm, str(tmp_path / "lenet_ort"),
                        input_spec=[tp.to_tensor(x)])
    got = ort.InferenceSession(path).run(None, {"x0": x})[0]
    np.testing.assert_allclose(got, tm(tp.to_tensor(x)).numpy(), atol=1e-4)


def test_resnet18_logits_match(tmp_path):
    x = np.random.RandomState(1).randn(1, 3, 64, 64).astype(np.float32)
    _, ops = export_both(
        lambda pkg: pkg.vision.models.resnet18(num_classes=10), x, tmp_path,
        "resnet18", seed=1)
    assert ops.count("BatchNormalization") == 20
    assert "GlobalAveragePool" in ops and "Add" in ops


def test_conv_stride_padding_groups(tmp_path):
    def build(pkg):
        class Net(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.c1 = pkg.nn.Conv2D(4, 8, 3, stride=2, padding=1)
                self.c2 = pkg.nn.Conv2D(8, 8, 3, padding=2, dilation=2,
                                        groups=2)

            def forward(self, x):
                F = pkg.nn.functional
                return F.relu(self.c2(F.relu(self.c1(x))))
        return Net()
    x = np.random.RandomState(2).randn(2, 4, 16, 16).astype(np.float32)
    export_both(build, x, tmp_path, "convs", seed=2)


def test_pool_and_softmax(tmp_path):
    def build(pkg):
        class Net(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(16, 4)

            def forward(self, x):
                F = pkg.nn.functional
                h = F.avg_pool2d(x, 2, stride=2)
                h = pkg.ops.reshape(h, [h.shape[0], -1])
                return F.softmax(self.fc(h), axis=-1)
        return Net()
    x = np.random.RandomState(3).randn(2, 4, 4, 4).astype(np.float32)
    _, ops = export_both(build, x, tmp_path, "pool_softmax", seed=3)
    assert ops[0] == "AveragePool" and ops[-1] == "Softmax"


def test_same_padding_roundtrip(tmp_path):
    def build(pkg):
        class Net(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.c = pkg.nn.Conv2D(3, 6, 3, stride=2, padding="SAME")

            def forward(self, x):
                F = pkg.nn.functional
                return F.max_pool2d(F.relu(self.c(x)), 2, stride=2,
                                    padding="SAME")
        return Net()
    x = np.random.RandomState(4).randn(2, 3, 9, 9).astype(np.float32)
    export_both(build, x, tmp_path, "same_pad", seed=4)


def test_flatten_variants(tmp_path):
    def build(pkg):
        class Net(pkg.nn.Layer):
            def forward(self, x):
                a = pkg.ops.flatten(x, start_axis=1)      # Flatten
                b = pkg.ops.flatten(x, start_axis=0)      # full ravel
                return a, pkg.ops.reshape(b, [1, -1])
        return Net()
    x = np.random.RandomState(5).randn(2, 3, 4).astype(np.float32)
    _, ops = export_both(build, x, tmp_path, "flat")
    assert ops == ["Flatten", "Reshape", "Reshape"]


def test_batch_merging_reshape(tmp_path):
    def build(pkg):
        class Net(pkg.nn.Layer):
            def forward(self, x):
                return pkg.ops.reshape(x, [x.shape[0] * x.shape[1], -1])
        return Net()
    x = np.random.RandomState(6).randn(2, 3, 4).astype(np.float32)
    path, _ = export_both(build, x, tmp_path, "merge")
    np.testing.assert_allclose(tonnx.run(path, {"x0": x})[0],
                               x.reshape(6, 4), atol=1e-6)


def test_unsupported_op_raises_clearly(tmp_path):
    x = np.random.RandomState(7).randn(2, 3).astype(np.float32)
    for pkg, onnx in ((jp, jonnx), (tp, tonnx)):
        class Net(pkg.nn.Layer):
            def forward(self, x):
                return pkg.ops.cumsum(x, axis=1)

        with pytest.raises(NotImplementedError, match="cumsum"):
            onnx.export(Net(), str(tmp_path / f"bad_{pkg.__name__}"),
                        input_spec=[pkg.to_tensor(x)])


def test_onnx_export_requires_input_spec():
    for onnx in (jonnx, tonnx):
        with pytest.raises(ValueError, match="input_spec"):
            onnx.export(None, "x")


def test_export_hook_sees_semantic_attrs():
    """The dispatcher's export hook gets each op's semantic parameters,
    the JAX package's keys, and an unregistered hook sees nothing."""
    seen = []

    def hook(op, ins, outs, attrs):
        seen.append((op, {k: attrs[k] for k in attrs
                          if k in ("stride", "padding", "groups", "axis",
                                   "kernel_size", "start_axis")}))
    x = tp.to_tensor(np.ones((1, 2, 4, 4), np.float32))
    conv = tp.nn.Conv2D(2, 2, 3, stride=2, padding=1, groups=2)
    tp.core.dispatch.register_export_hook(hook)
    try:
        y = tp.nn.functional.max_pool2d(conv(x), 2)
        tp.nn.functional.softmax(tp.ops.flatten(y, start_axis=1), axis=-1)
    finally:
        tp.core.dispatch.unregister_export_hook(hook)
    conv(x)
    assert seen == [
        ("conv2d", {"stride": (2, 2), "padding": [(1, 1), (1, 1)],
                    "groups": 2}),
        ("max_pool2d", {"stride": (2, 2), "padding": [(0, 0), (0, 0)],
                        "kernel_size": (2, 2)}),
        ("flatten", {"start_axis": 1}),
        ("softmax", {"axis": -1})]
