"""The port's ``fault.retry`` and ``fault.CheckpointManager`` (with
``capture_train_state``, ``restore_train_state`` and ``auto_resume``)
against the JAX package's.

The JAX package's ``TestCheckpointManager`` and ``TestRetryBackoff``
cases (``tests/test_fault.py``) run on the port; the retry schedules of
both packages under one seeded jitter must be equal. A directory one
package's manager writes, the other's restores: the model's and the
optimizer's state bit for bit, and every parameter's moments restored
(counted, since both packages skip state keys they do not find).
"""
import json
import random

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import fault as j_fault
from paddle_tpu.fault import inject as j_inject
from paddle_tpu.fault.retry import RetryPolicy as JRetryPolicy
from paddle_tpu.fault.retry import retry as j_retry
import paddle_tpu_torch as tp
from paddle_tpu_torch import fault as t_fault
from paddle_tpu_torch.fault import inject as t_inject
from paddle_tpu_torch.fault.retry import RetryPolicy, retry
from paddle_tpu_torch.observability import REGISTRY, goodput


@pytest.fixture(autouse=True)
def _clean():
    t_inject.disarm_all()
    j_inject.disarm_all()
    tp.set_flags({"FLAGS_enable_metrics": False})
    REGISTRY.reset()
    with tp.device_guard("cpu"):
        yield
    t_inject.disarm_all()
    j_inject.disarm_all()
    tp.set_flags({"FLAGS_enable_metrics": False})
    REGISTRY.reset()


def _save_n(mgr, pkg, n, size=8):
    for s in range(n):
        mgr.save({"model": {"x": pkg.to_tensor(
            np.full(size, float(s), np.float32))}}, step=s, epoch=s)


# ------------------------------------------- the JAX package's manager cases
def test_rotation_keep_n_and_manifest(tmp_path):
    """The same saves leave the same files and manifest entries (all but
    the byte counts) in either package's directory."""
    mgrs = {}
    for pkg, fault in (("jax", j_fault), ("port", t_fault)):
        mgr = fault.CheckpointManager(str(tmp_path / pkg), keep_n=3)
        _save_n(mgr, jp if pkg == "jax" else tp, 5)
        mgrs[pkg] = mgr
    mgr = mgrs["port"]
    assert len(mgr.checkpoints()) == 3
    assert [e["step"] for e in mgr.manifest()] == [2, 3, 4]
    assert mgr.latest().endswith("ckpt-0000000004.pdckpt")
    assert mgr.steps() == [4, 3, 2]

    def strip(entries):
        return [{k: v for k, v in e.items() if k != "bytes"}
                for e in entries]
    with open(mgr._manifest_path()) as f:
        assert strip(json.load(f)) == strip(mgrs["jax"].manifest())


def test_fallback_past_corrupt_latest(tmp_path):
    mgr = t_fault.CheckpointManager(str(tmp_path), keep_n=4)
    _save_n(mgr, tp, 3)
    newest = mgr.latest()
    body = bytearray(open(newest, "rb").read())
    body[len(body) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(body))
    tp.set_flags({"FLAGS_enable_metrics": True})
    with pytest.warns(UserWarning, match="skipping"):
        state, meta = mgr.restore()
    assert meta["step"] == 1 and mgr.last_fallback_depth == 1
    np.testing.assert_array_equal(state["model"]["x"].numpy(),
                                  np.full(8, 1.0))
    assert REGISTRY.get("paddle_tpu_resume_fallback_depth").value() == 1.0
    assert REGISTRY.get("paddle_tpu_resume_fallback_total").value() == 1.0


def test_fallback_past_partial_write(tmp_path):
    mgr = t_fault.CheckpointManager(str(tmp_path), keep_n=4)
    _save_n(mgr, tp, 2)
    newest = mgr.latest()
    raw = open(newest, "rb").read()
    open(newest, "wb").write(raw[:len(raw) // 3])
    with pytest.warns(UserWarning):
        state, meta = mgr.restore()
    assert meta["step"] == 0 and mgr.last_fallback_depth == 1


def test_restore_none_when_all_corrupt(tmp_path):
    mgr = t_fault.CheckpointManager(str(tmp_path), keep_n=4)
    _save_n(mgr, tp, 2)
    for p in mgr.checkpoints():
        open(p, "wb").write(b"garbage")
    with pytest.warns(UserWarning):
        assert mgr.restore() is None
    assert mgr.last_fallback_depth is None


def test_restore_max_step_bounds_the_candidates(tmp_path):
    mgr = t_fault.CheckpointManager(str(tmp_path), keep_n=4)
    _save_n(mgr, tp, 3)
    state, meta = mgr.restore(max_step=1)
    assert meta["step"] == 1 and mgr.last_fallback_depth == 0


def test_save_retries_transient_rename_failure(tmp_path):
    mgr = t_fault.CheckpointManager(str(tmp_path), keep_n=2)
    tp.set_flags({"FLAGS_enable_metrics": True})
    with t_inject.armed("io.rename_fail", times=1):
        mgr.save({"model": {}}, step=0)   # retried past one failure
    assert len(mgr.checkpoints()) == 1
    assert REGISTRY.get("paddle_tpu_fault_retries_total").value(
        site="ckpt.save") == 1.0


def test_save_retry_exhaustion_surfaces_original_error(tmp_path):
    mgr = t_fault.CheckpointManager(
        str(tmp_path), keep_n=2,
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.001))
    with t_inject.armed("io.rename_fail", times=5):
        with pytest.raises(OSError):
            mgr.save({"model": {}}, step=0)
    assert mgr.checkpoints() == []


def test_keep_n_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="keep_n"):
        t_fault.CheckpointManager(str(tmp_path), keep_n=0)


# --------------------------------------------------------------- retry
def _fake():
    sleeps = []
    clock = {"t": 0.0}

    def sleep(d):
        sleeps.append(d)
        clock["t"] += d

    return sleeps, (lambda: clock["t"]), sleep


POLICIES = {
    "exponential": (dict(max_attempts=4, base_delay=0.1, multiplier=2.0,
                         jitter=0.0), TimeoutError),
    "max_delay": (dict(max_attempts=5, base_delay=0.1, multiplier=4.0,
                       max_delay=0.5, jitter=0.0), OSError),
    "deadline": (dict(max_attempts=10, base_delay=0.1, multiplier=2.0,
                      jitter=0.0, deadline=0.25), TimeoutError),
    "jitter": (dict(max_attempts=6, base_delay=0.1, jitter=0.5),
               TimeoutError),
    "jitter_deadline": (dict(max_attempts=8, base_delay=0.05,
                             multiplier=3.0, jitter=0.3, deadline=2.0),
                        OSError),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_retry_schedule_equals_jax(name):
    """Both packages sleep the same schedule, under the same seeded jitter,
    and re-raise the original error after the same attempts."""
    kw, exc = POLICIES[name]
    runs = []
    for policy_cls, retry_fn in ((JRetryPolicy, j_retry),
                                 (RetryPolicy, retry)):
        sleeps, clock, sleep = _fake()
        calls = {"n": 0}

        def fn():
            calls["n"] += 1
            raise exc("boom")

        with pytest.raises(exc, match="boom"):
            retry_fn(fn, policy_cls(**kw), sleep=sleep, clock=clock,
                     rng=random.Random(7))
        runs.append((sleeps, calls["n"]))
    assert runs[1] == runs[0]
    assert runs[1][0], name


def test_retry_expected_schedules():
    sleeps, clock, sleep = _fake()
    with pytest.raises(TimeoutError):
        retry(lambda: (_ for _ in ()).throw(TimeoutError()),
              RetryPolicy(**POLICIES["exponential"][0]), sleep=sleep,
              clock=clock)
    assert sleeps == pytest.approx([0.1, 0.2, 0.4])
    sleeps, clock, sleep = _fake()
    with pytest.raises(TimeoutError):
        retry(lambda: (_ for _ in ()).throw(TimeoutError()),
              RetryPolicy(**POLICIES["deadline"][0]), sleep=sleep,
              clock=clock)
    assert sleeps == pytest.approx([0.1])


def test_success_after_transient_failures_and_non_retryable():
    sleeps, clock, sleep = _fake()
    state = {"n": 0}

    def fn():
        state["n"] += 1
        if state["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert retry(fn, RetryPolicy(max_attempts=5, jitter=0.0),
                 sleep=sleep, clock=clock) == "ok"
    assert len(sleeps) == 2
    sleeps, clock, sleep = _fake()
    with pytest.raises(KeyError):
        retry(lambda: (_ for _ in ()).throw(KeyError("x")),
              RetryPolicy(max_attempts=5), sleep=sleep, clock=clock)
    assert sleeps == []
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


# -------------------------------------------------- across the packages
SIZES = (5, 7, 3)


def _jax_run(steps=2):
    """A named JAX MLP trained ``steps`` AdamW steps with a scheduler."""
    rng = np.random.RandomState(0)
    net = jp.nn.Sequential(jp.nn.Linear(SIZES[0], SIZES[1]), jp.nn.ReLU(),
                           jp.nn.Linear(SIZES[1], SIZES[2]))
    sched = jp.optimizer.lr.StepDecay(0.01, step_size=1, gamma=0.5)
    opt = jp.optimizer.AdamW(learning_rate=sched,
                             parameters=net.parameters())
    for _ in range(steps):
        x = jp.to_tensor(rng.randn(4, SIZES[0]).astype(np.float32))
        net(x).sum().backward()
        opt.step()
        opt.clear_grad()
        sched.step()
    return net, opt


def _port_twin(jnet, seed=5):
    """A port MLP of the same structure from another seed, its parameters
    named as the JAX model's, and its AdamW with a fresh scheduler."""
    tp.seed(seed)
    net = tp.nn.Sequential(tp.nn.Linear(SIZES[0], SIZES[1]), tp.nn.ReLU(),
                           tp.nn.Linear(SIZES[1], SIZES[2]))
    for p, q in zip(net.parameters(), jnet.parameters()):
        p.name = q.name
    sched = tp.optimizer.lr.StepDecay(0.01, step_size=1, gamma=0.5)
    opt = tp.optimizer.AdamW(learning_rate=sched,
                             parameters=net.parameters())
    return net, opt


def _restored_accumulators(opt, net):
    return sum(1 for p in net.parameters() if p.name in opt._accumulators)


def _assert_same_state(port_net, port_opt, jnet, jopt):
    for k, v in jnet.state_dict().items():
        np.testing.assert_array_equal(port_net.state_dict()[k].numpy(),
                                      np.asarray(v._data), err_msg=k)
    j_sd, t_sd = jopt.state_dict(), port_opt.state_dict()
    assert set(t_sd) == set(j_sd)
    for k, v in j_sd.items():
        if hasattr(v, "_data"):
            np.testing.assert_array_equal(t_sd[k].numpy(),
                                          np.asarray(v._data), err_msg=k)
        else:
            assert t_sd[k] == v, k


def test_jax_directory_resumes_on_the_port(tmp_path):
    jnet, jopt = _jax_run()
    jmgr = j_fault.CheckpointManager(str(tmp_path), keep_n=2)
    jmgr.save(j_fault.capture_train_state(jnet, jopt), step=2, epoch=0,
              meta={"step_in_epoch": 1})
    net, opt = _port_twin(jnet)
    goodput.reset_ledger()
    goodput.ledger().run_begin()
    meta = t_fault.auto_resume(t_fault.CheckpointManager(str(tmp_path)),
                               network=net, optimizer=opt)
    snap = goodput.ledger().snapshot()
    assert meta == {"step_in_epoch": 1, "step": 2, "epoch": 0}
    assert _restored_accumulators(opt, net) == len(net.parameters())
    _assert_same_state(net, opt, jnet, jopt)
    assert opt._learning_rate.last_epoch == jopt._learning_rate.last_epoch
    assert snap["buckets"]["checkpoint"] > 0
    assert goodput.ledger().resumes[-1]["restored_step"] == 2
    goodput.reset_ledger()


def test_port_directory_resumes_in_jax(tmp_path):
    jnet, jopt = _jax_run()
    net, opt = _port_twin(jnet)
    t_fault.restore_train_state(
        {"model": {k: np.asarray(v._data)
                   for k, v in jnet.state_dict().items()},
         "optimizer": {k: (np.array(v._data) if hasattr(v, "_data") else v)
                       for k, v in jopt.state_dict().items()}},
        network=net, optimizer=opt)
    tmgr = t_fault.CheckpointManager(str(tmp_path), keep_n=2)
    tmgr.save(t_fault.capture_train_state(net, opt), step=2, epoch=0)
    jnet2, jopt2 = _jax_run(steps=0)
    for p, q in zip(jnet2.parameters(), net.parameters()):
        p.name = q.name
    jopt2 = jp.optimizer.AdamW(
        learning_rate=jp.optimizer.lr.StepDecay(0.01, step_size=1,
                                                gamma=0.5),
        parameters=jnet2.parameters())
    meta = j_fault.auto_resume(j_fault.CheckpointManager(str(tmp_path)),
                               network=jnet2, optimizer=jopt2)
    assert meta["step"] == 2
    assert len(jopt2._accumulators) == len(jnet2.parameters())
    _assert_same_state(net, opt, jnet2, jopt2)


def test_restore_copies_into_live_tensors(tmp_path):
    """restore_train_state writes into the parameters the optimizer
    holds, and keeps no reference to the loaded state."""
    jnet, _ = _jax_run(steps=0)
    src, src_opt = _port_twin(jnet)
    src(tp.to_tensor(np.ones((2, SIZES[0]), np.float32))).sum().backward()
    src_opt.step()
    mgr = t_fault.CheckpointManager(str(tmp_path))
    mgr.save(t_fault.capture_train_state(src, src_opt), step=1)
    net, opt = _port_twin(jnet, seed=9)
    payloads = [p._data for p in net.parameters()]
    state, _ = mgr.restore()
    t_fault.restore_train_state(state, network=net, optimizer=opt)
    assert all(p._data is d for p, d in zip(net.parameters(), payloads))
    assert all(a is b for a, b in zip(opt._parameter_list, payloads))
    assert _restored_accumulators(opt, net) == len(net.parameters())
    loaded = {id(v._data) for v in state["optimizer"].values()
              if isinstance(v, tp.Tensor)}
    held = {id(t) for st in opt._accumulators.values() for t in st.values()}
    assert held and not loaded & held
    for k, v in src.state_dict().items():
        torch.testing.assert_close(net.state_dict()[k]._data, v._data,
                                   atol=0, rtol=0)
