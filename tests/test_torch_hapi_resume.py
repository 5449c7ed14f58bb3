"""The port's ``hapi`` checkpointing (``ModelCheckpoint``, ``Model.save``/
``load``, ``fit(save_dir=...)``, ``fit(resume=...)``) against the JAX
package's.

The JAX package's ``TestHapiResume`` and the resume cases of
``TestReviewRegressions`` (``tests/test_fault.py``) run on both packages.
Across the packages: the JAX package fits a tiny MLP with
``ModelCheckpoint(manager=..., save_steps=4)`` and stops mid-epoch; the
port's ``fit(resume=mgr)`` on that directory ends with the weights of the
JAX package's own resumed run within TOL (fp32), every parameter's Adam
moments restored (counted: both packages skip state keys they do not
find, so the fresh models carry the saved run's parameter names).
``Model.save``/``load`` files cross both ways bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.fault import inject as j_inject
import paddle_tpu_torch as tp
from paddle_tpu_torch.fault import inject as t_inject

TOL = 1e-5
PKGS = {"jax": jp, "port": tp}
INJECT = {"jax": j_inject, "port": t_inject}


@pytest.fixture(autouse=True)
def _clean():
    t_inject.disarm_all()
    j_inject.disarm_all()
    with tp.device_guard("cpu"):
        yield
    t_inject.disarm_all()
    j_inject.disarm_all()


class _DS:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.randn(4).astype("float32"), np.int64(i % 3)


def _make_model(pkg, names=None):
    net = pkg.nn.Sequential(pkg.nn.Linear(4, 8), pkg.nn.ReLU(),
                            pkg.nn.Linear(8, 3))
    if names is not None:          # the saved run's parameter names
        for p, n in zip(net.parameters(), names):
            p.name = n
    model = pkg.Model(net)
    opt = pkg.optimizer.Adam(learning_rate=1e-2,
                             parameters=net.parameters())
    model.prepare(opt, pkg.nn.CrossEntropyLoss())
    return model, net


def _weight(net, key="0.weight"):
    return np.asarray(net.state_dict()[key].numpy()).copy()


# ----------------------------------------- the JAX package's TestHapiResume
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_step_granular_auto_resume(tmp_path, pkg):
    paddle = PKGS[pkg]
    mgr = paddle.fault.CheckpointManager(str(tmp_path), keep_n=8)
    model, net = _make_model(paddle)
    cb = paddle.hapi.ModelCheckpoint(manager=mgr, save_steps=4)
    model.fit(_DS(), epochs=2, batch_size=8, verbose=0, shuffle=False,
              callbacks=[cb])
    assert model._global_step == 8
    model2, _ = _make_model(paddle)
    model2.fit(_DS(), epochs=3, batch_size=8, verbose=0, shuffle=False,
               callbacks=[paddle.hapi.ModelCheckpoint(
                   manager=mgr, save_steps=4)], resume=mgr)
    assert model2._global_step == 12
    assert model2._optimizer._step_count == 12


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_resume_restores_weights_and_scaler(tmp_path, pkg):
    paddle = PKGS[pkg]
    mgr = paddle.fault.CheckpointManager(str(tmp_path), keep_n=4)
    model, net = _make_model(paddle)
    scaler = paddle.amp.GradScaler(enable=True, init_loss_scaling=1024.0)
    scaler._scale = 123.0
    cb = paddle.hapi.ModelCheckpoint(manager=mgr, scaler=scaler)
    model.fit(_DS(), epochs=1, batch_size=8, verbose=0, shuffle=False,
              callbacks=[cb])
    w = _weight(net)
    model2, net2 = _make_model(paddle)
    scaler2 = paddle.amp.GradScaler(enable=True)
    start_epoch, skip = model2._auto_resume(
        mgr, [paddle.hapi.ModelCheckpoint(manager=mgr, scaler=scaler2)], 0)
    assert (start_epoch, skip) == (1, 0)
    np.testing.assert_array_equal(_weight(net2), w)
    assert scaler2._scale == 123.0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_resume_skips_corrupt_latest(tmp_path, pkg):
    paddle = PKGS[pkg]
    mgr = paddle.fault.CheckpointManager(str(tmp_path), keep_n=8)
    model, _ = _make_model(paddle)
    model.fit(_DS(), epochs=2, batch_size=8, verbose=0, shuffle=False,
              callbacks=[paddle.hapi.ModelCheckpoint(manager=mgr)])
    newest = mgr.latest()
    body = bytearray(open(newest, "rb").read())
    body[len(body) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(body))
    model2, _ = _make_model(paddle)
    with pytest.warns(UserWarning, match="skipping"):
        model2.fit(_DS(), epochs=3, batch_size=8, verbose=0,
                   shuffle=False, resume=mgr)
    assert mgr.last_fallback_depth == 1
    assert model2._global_step == 12


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_nan_injection_skips_step_keeps_weights_finite(pkg):
    paddle = PKGS[pkg]
    model, net = _make_model(paddle)
    INJECT[pkg].arm("grads.nan_at_step", step=1)
    model.fit(_DS(), epochs=1, batch_size=8, verbose=0, shuffle=False)
    assert model._nonfinite_steps == 1
    for name, p in net.state_dict().items():
        assert np.isfinite(np.asarray(p.numpy())).all(), name


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_restore_on_nonfinite_rolls_back(tmp_path, pkg):
    paddle = PKGS[pkg]
    mgr = paddle.fault.CheckpointManager(str(tmp_path), keep_n=4)
    model, net = _make_model(paddle)
    cb = paddle.hapi.ModelCheckpoint(manager=mgr, save_steps=2,
                                     restore_on_nonfinite=True)
    INJECT[pkg].arm("grads.nan_at_step", step=3)
    model.fit(_DS(), epochs=1, batch_size=8, verbose=0, shuffle=False,
              callbacks=[cb])
    assert cb.restored_nonfinite == 1
    for name, p in net.state_dict().items():
        assert np.isfinite(np.asarray(p.numpy())).all(), name


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_model_checkpoint_argument_checks(pkg):
    paddle = PKGS[pkg]
    with pytest.raises(ValueError, match="restore_on_nonfinite"):
        paddle.hapi.ModelCheckpoint(restore_on_nonfinite=True)
    with pytest.raises(ValueError, match="save_steps"):
        paddle.hapi.ModelCheckpoint(save_steps=2)


# ---------------------------- the JAX package's TestReviewRegressions (resume)
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fully_resumed_fit_does_not_overwrite_newest(tmp_path, pkg):
    paddle = PKGS[pkg]
    mgr = paddle.fault.CheckpointManager(str(tmp_path), keep_n=4)
    model, _ = _make_model(paddle)
    cb = paddle.hapi.ModelCheckpoint(manager=mgr)
    model.fit(_DS(), epochs=2, batch_size=8, verbose=0, shuffle=False,
              callbacks=[cb])
    newest = mgr.latest()
    before = open(newest, "rb").read()
    model2, _ = _make_model(paddle)
    hist = model2.fit(_DS(), epochs=2, batch_size=8, verbose=0,
                      shuffle=False, callbacks=[cb], resume=mgr)
    assert hist == []
    assert mgr.latest() == newest
    assert open(newest, "rb").read() == before
    model3, _ = _make_model(paddle)
    assert model3._auto_resume(mgr, [], 0) == (2, 0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_resume_skipping_whole_epoch_reports_no_nan_loss(tmp_path, pkg):
    paddle = PKGS[pkg]
    mgr = paddle.fault.CheckpointManager(str(tmp_path), keep_n=8)
    model, net = _make_model(paddle)
    model.fit(_DS(), epochs=1, batch_size=8, verbose=0, shuffle=False)
    mgr.save(paddle.fault.capture_train_state(network=net,
                                              optimizer=model._optimizer),
             step=4, epoch=0,
             meta={"epoch_complete": False, "step_in_epoch": 3})
    model2, _ = _make_model(paddle)
    hist = model2.fit(_DS(), epochs=2, batch_size=8, verbose=0,
                      shuffle=False, resume=mgr)
    assert all(np.isfinite(hist))
    assert model2._global_step == 8


# ------------------------------------------------------------ port only
def test_resume_in_a_larger_world_is_a_later_slice(tmp_path, monkeypatch):
    mgr = tp.fault.CheckpointManager(str(tmp_path))
    model, _ = _make_model(tp)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="consensus_resume"):
        model.fit(_DS(), epochs=1, batch_size=8, verbose=0, resume=mgr)


def test_fit_without_a_checkpoint_starts_fresh(tmp_path):
    mgr = tp.fault.CheckpointManager(str(tmp_path))
    model, _ = _make_model(tp)
    hist = model.fit(_DS(), epochs=1, batch_size=8, verbose=0,
                     shuffle=False, resume=mgr)
    assert len(hist) == 1 and model._global_step == 4


# ------------------------------------------------------ across the packages
class _Stop(Exception):
    pass


class _StopAt(jp.hapi.Callback):
    """Ends the JAX run after a global step, as a preemption would: no
    epoch-end or train-end save follows."""

    def __init__(self, step):
        super().__init__()
        self.step = step

    def on_train_batch_end(self, step, logs=None):
        if self.model._global_step == self.step:
            raise _Stop()


def test_jax_manager_directory_resumes_a_port_fit(tmp_path):
    """A JAX fit saves every 4 steps and is cut at step 5 (6 steps an
    epoch); the port resumes the step-4 checkpoint mid-epoch, and its
    weights after the remaining steps equal the JAX package's own resumed
    run's."""
    data = [(np.random.RandomState(i).randn(4).astype("float32"),
             np.int64(i % 3)) for i in range(48)]
    mgr = jp.fault.CheckpointManager(str(tmp_path), keep_n=4)
    model, net = _make_model(jp)
    names = [p.name for p in net.parameters()]
    with pytest.raises(_Stop):
        model.fit(data, epochs=2, batch_size=8, verbose=0, shuffle=False,
                  callbacks=[jp.hapi.ModelCheckpoint(manager=mgr,
                                                     save_steps=4),
                             _StopAt(5)])
    assert mgr.steps() == [4]
    runs = {}
    for pkg in ("jax", "port"):
        paddle = PKGS[pkg]
        resumed, rnet = _make_model(paddle, names)
        start = resumed._auto_resume(
            paddle.fault.CheckpointManager(str(tmp_path)), [], 0)
        assert start == (0, 4)
        assert len(resumed._optimizer._accumulators) == len(names)
        assert resumed._optimizer._step_count == 4
        resumed, rnet = _make_model(paddle, names)
        resumed.fit(data, epochs=2, batch_size=8, verbose=0, shuffle=False,
                    resume=paddle.fault.CheckpointManager(str(tmp_path)))
        assert resumed._global_step == 12
        runs[pkg] = {k: np.asarray(v.numpy())
                     for k, v in rnet.state_dict().items()}
    for k, ref in runs["jax"].items():
        np.testing.assert_allclose(runs["port"][k], ref, rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_model_save_load_cross_both_ways(tmp_path, writer):
    """Model.save writes .pdparams/.pdopt; the other package's Model.load
    restores the weights bit for bit and the optimizer's state under the
    same names; reset_optimizer leaves the optimizer untouched."""
    reader = "port" if writer == "jax" else "jax"
    src, snet = _make_model(PKGS[writer])
    src.fit(_DS(), epochs=1, batch_size=8, verbose=0, shuffle=False)
    path = str(tmp_path / "m")
    src.save(path)
    dst, dnet = _make_model(PKGS[reader],
                            [p.name for p in snet.parameters()])
    dst.load(path, reset_optimizer=True)
    assert dst._optimizer._step_count == 0
    dst.load(path)
    for k, v in snet.state_dict().items():
        np.testing.assert_array_equal(
            np.asarray(dnet.state_dict()[k].numpy()), np.asarray(v.numpy()),
            err_msg=k)
    assert dst._optimizer._step_count == src._optimizer._step_count == 4
    assert len(dst._optimizer._accumulators) == len(snet.parameters())
    src_sd, dst_sd = src._optimizer.state_dict(), dst._optimizer.state_dict()
    assert set(dst_sd) == set(src_sd)
    for k, v in src_sd.items():
        if k != "@step_count":
            np.testing.assert_array_equal(np.asarray(dst_sd[k]),
                                          np.asarray(v), err_msg=k)


def test_fit_save_dir_writes_epochs_the_jax_package_loads(tmp_path):
    model, net = _make_model(tp)
    cb = tp.hapi.ModelCheckpoint(save_dir=str(tmp_path / "cb"))
    model.fit(_DS(), epochs=2, batch_size=8, verbose=0, shuffle=False,
              save_dir=str(tmp_path / "fit"), save_freq=1, callbacks=[cb])
    for name in ("fit/epoch_0", "fit/epoch_1", "cb/0", "cb/1", "cb/final"):
        assert (tmp_path / f"{name}.pdparams").exists(), name
        assert (tmp_path / f"{name}.pdopt").exists(), name
    ref = jp.load(str(tmp_path / "fit/epoch_1.pdparams"))
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(np.asarray(ref[k]._data), v.numpy())


def test_port_save_keeps_bf16_weights_bitwise(tmp_path):
    model, net = _make_model(tp)
    net.to(dtype="bfloat16")
    model.save(str(tmp_path / "bf"), training=False)
    assert not (tmp_path / "bf.pdopt").exists()
    ref = jp.load(str(tmp_path / "bf.pdparams"))
    for k, v in net.state_dict().items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(ref[k]._data).view(np.int16),
            v._data.view(torch.int16).numpy(), err_msg=k)
