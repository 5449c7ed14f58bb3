"""The port's inference ``Predictor`` (``inference.Config``,
``create_predictor``, the handles) against the JAX package's, the same
numpy weights in both: the predictor cases of
``tests/test_coverage_round2b.py``, each run on both packages with the
outputs within 1e-6. The port's predictor runs on the card unless the
config calls ``disable_gpu()``, so its CPU cases do; without CUDA and
without ``disable_gpu()`` it raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def seeded_state(layer, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape) / np.sqrt(v.shape[0])).astype(
        np.float32) for k, v in layer.state_dict().items()}


def config(pkg, prefix, *files):
    cfg = pkg.inference.Config(prefix, *files)
    if pkg is tp:
        cfg.disable_gpu()
    return cfg


def test_round_trip(tmp_path):
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    outs = []
    for pkg in (jp, tp):
        net = pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                                pkg.nn.Linear(16, 4))
        if pkg is jp:
            state = seeded_state(net, 0)
            net.set_state_dict(state)
        else:
            load_jax_layer_state(net, state)
        ref = np.asarray(net(pkg.to_tensor(x)).numpy())
        prefix = str(tmp_path / f"model_{pkg.__name__}")
        pkg.jit.save(net, prefix,
                     input_spec=[pkg.static.InputSpec([-1, 8], "float32")])
        pred = pkg.inference.create_predictor(config(pkg, prefix))
        h = pred.get_input_handle(pred.get_input_names()[0])
        h.copy_from_cpu(x)
        pred.run()
        out = pred.get_output_handle(pred.get_output_names()[0])
        got = out.copy_to_cpu()
        assert isinstance(got, np.ndarray) and out.shape() == [2, 4]
        np.testing.assert_allclose(got, ref, atol=ATOL)
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], atol=ATOL)


def test_multi_input_model(tmp_path):
    rng = np.random.RandomState(1)
    a = rng.randn(2, 8).astype(np.float32)
    b = rng.randn(2, 8).astype(np.float32)
    outs = []
    for pkg in (jp, tp):
        class TwoIn(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(8, 4)

            def forward(self, a, b):
                return self.fc(a + b)

        net = TwoIn()
        if pkg is jp:
            state = seeded_state(net, 1)
        net.set_state_dict(state)
        ref = np.asarray(net(pkg.to_tensor(a), pkg.to_tensor(b)).numpy())
        prefix = str(tmp_path / f"two_{pkg.__name__}")
        pkg.jit.save(net, prefix,
                     input_spec=[pkg.static.InputSpec([-1, 8], "float32"),
                                 pkg.static.InputSpec([-1, 8], "float32")])
        pred = pkg.inference.create_predictor(config(pkg, prefix))
        names = pred.get_input_names()
        assert names == ["input_0", "input_1"]
        pred.get_input_handle(names[0]).copy_from_cpu(a)
        with pytest.raises(RuntimeError, match="never set"):
            pred.run()
        pred.get_input_handle(names[1]).copy_from_cpu(b)
        pred.run()
        got = pred.get_output_handle("output_0").copy_to_cpu()
        np.testing.assert_allclose(got, ref, atol=ATOL)
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], atol=ATOL)


def test_params_only_rejected(tmp_path):
    for pkg in (jp, tp):
        net = pkg.nn.Linear(4, 4)
        prefix = str(tmp_path / f"weights_{pkg.__name__}")
        pkg.framework.io.save(net.state_dict(), prefix + ".pdparams")
        with pytest.raises(ValueError, match="pdmodel"):
            pkg.inference.create_predictor(config(pkg, prefix))


def test_config_takes_the_file_names(tmp_path):
    """``Config("x.pdmodel", "x.pdiparams")`` names the same artifact as
    its prefix (``tests/test_round5.py``'s form)."""
    net = tp.nn.Linear(8, 4)
    prefix = str(tmp_path / "files")
    tp.jit.save(net, prefix, input_spec=[tp.static.InputSpec([-1, 8])])
    cfg = config(tp, prefix + ".pdmodel", prefix + ".pdiparams")
    assert cfg.prefix == prefix and not cfg.use_gpu()
    x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    pred = tp.inference.create_predictor(cfg)
    pred.get_input_handle("input_0").copy_from_cpu(x)
    pred.run()
    np.testing.assert_allclose(
        pred.get_output_handle("output_0").copy_to_cpu(),
        net(tp.to_tensor(x)).numpy(), atol=ATOL)


def test_no_cuda_and_no_disable_gpu_raises(tmp_path, monkeypatch):
    net = tp.nn.Linear(8, 4)
    prefix = str(tmp_path / "gpu_default")
    tp.jit.save(net, prefix, input_spec=[tp.static.InputSpec([-1, 8])])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tp.inference.Config(prefix)
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.inference.create_predictor(cfg)
    cfg.enable_use_gpu(device_id=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.inference.create_predictor(cfg)
    cfg.disable_gpu()
    assert tp.inference.create_predictor(cfg).device.type == "cpu"
