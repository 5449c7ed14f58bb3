"""The port's ``io``, ``metric``, ``hapi`` callbacks and ``Model`` against
the JAX package's.

The cases of the JAX package's ``tests/test_models_hapi.py``
(``TestHapiModel`` without save/load, ``TestMetrics``, ``TestCallbacks``
without the checkpoint cases) run on both packages with the same
weights (``load_jax_layer_state``) and the same numpy-seeded data; the
fit histories, ``evaluate`` results, ``predict`` outputs, metric values
and callback traces are held to the JAX package's (losses to 1e-5).
Beside them: the samplers' order under a seeded ``np.random``, a
``num_workers=2`` fit under a time limit of its own, the prefetcher's
teardown, and the goodput ledger's and the sentinel's counts after
``fit``.
"""
import gc
import multiprocessing as mp
import signal

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _mlp(pkg, sizes, seed=0):
    nn = pkg.nn
    layers = []
    for i, (a, b) in enumerate(zip(sizes, sizes[1:])):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Linear(a, b))
    return nn.Sequential(*layers)


def _pair(sizes):
    """A JAX MLP and its port twin on the same weights."""
    jp.seed(0)
    j = _mlp(jp, sizes)
    t = _mlp(tp, sizes)
    load_jax_layer_state(t, _state(j))
    return j, t


def _xor_ds(pkg, n=32):
    """tests/test_models_hapi.py's XorDs, for either package."""
    class XorDs(pkg.io.Dataset):
        def __init__(self):
            rng = np.random.RandomState(0)
            self.x = rng.randn(n, 8).astype(np.float32)
            self.y = (self.x[:, :1] > 0).astype(np.int64).reshape(-1)

        def __len__(self):
            return n

        def __getitem__(self, i):
            return self.x[i], self.y[i]
    return XorDs()


def _both(run):
    """``run(pkg, net)`` on each package's MLP twin; numpy's global RNG
    is seeded alike before each, so shuffled samplers draw alike."""
    out = []
    for pkg, net in zip((jp, tp), _pair([8, 32, 2])):
        np.random.seed(0)
        out.append(run(pkg, net))
    return out


# ------------------------------------------------------------ TestHapiModel
@pytest.mark.parametrize("shuffle", [False, True])
def test_fit_evaluate_predict(shuffle):
    def run(pkg, net):
        model = pkg.Model(net) if pkg is tp else pkg.hapi.Model(net)
        model.prepare(
            optimizer=pkg.optimizer.AdamW(learning_rate=1e-2,
                                          parameters=net.parameters()),
            loss=pkg.nn.CrossEntropyLoss(), metrics=pkg.metric.Accuracy())
        ds = _xor_ds(pkg)
        hist = model.fit(ds, batch_size=8, epochs=3, verbose=0,
                         shuffle=shuffle)
        res = model.evaluate(ds, batch_size=8, verbose=0)
        preds = model.predict(ds, batch_size=8, stack_outputs=True)
        return hist, res, preds
    (hj, rj, pj), (ht, rt, pt) = _both(run)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=TOL)
    assert ht[-1] < ht[0]
    assert list(rt) == list(rj) == ["loss", "acc"]
    np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=0, atol=TOL)
    assert rt["acc"] == rj["acc"] and rt["acc"] > 0.6
    assert pt[0].shape == pj[0].shape == (32, 2)
    np.testing.assert_allclose(pt[0], pj[0], rtol=TOL, atol=TOL)


def test_save_load_summary_raise_until_ported(tmp_path):
    """Ported since: save, load, summary, fit(save_dir=...) and
    fit(resume=...) no longer raise (held against the JAX package in
    test_torch_hapi_resume.py and test_torch_summary_flops.py)."""
    net = _mlp(tp, [8, 16, 2])
    model = tp.Model(net)
    model.prepare(tp.optimizer.Adam(parameters=net.parameters()),
                  tp.nn.CrossEntropyLoss())
    model.fit(_xor_ds(tp), batch_size=8, verbose=0,
              save_dir=str(tmp_path / "d"),
              resume=tp.fault.CheckpointManager(str(tmp_path / "m")))
    assert (tmp_path / "d" / "epoch_0.pdparams").exists()
    model.save(str(tmp_path / "x"))
    model.load(str(tmp_path / "x"))
    assert model.summary((1, 8)) == {"total_params": 8 * 16 + 16 + 16 * 2
                                     + 2, "trainable_params": 178}


# ---------------------------------------------------------------- metrics
METRIC_CASES = {
    "accuracy_topk": lambda M: _update(
        M.Accuracy(topk=(1, 2)), np.array([[0.1, 0.7, 0.2], [0.8, 0.1, 0.1]]),
        np.array([1, 2]), compute=True),
    "accuracy_ties": lambda M: _update(
        M.Accuracy(topk=(1, 2)),
        np.array([[0.5, 0.5, 0.2, 0.5], [0.3, 0.3, 0.3, 0.1]]),
        np.array([[3], [1]]), compute=True),
    "accuracy_column_labels": lambda M: _update(
        M.Accuracy(), np.array([[0.1, 0.9], [0.2, 0.8]]),
        np.array([[1], [1]]), compute=True),
    "precision": lambda M: _update(M.Precision(),
                                   np.array([0.9, 0.8, 0.2, 0.7]),
                                   np.array([1, 0, 1, 1])),
    "recall": lambda M: _update(M.Recall(), np.array([0.9, 0.8, 0.2, 0.7]),
                                np.array([1, 0, 1, 1])),
    "auc_perfect_separation": lambda M: _update(
        M.Auc(), np.array([0.9, 0.8, 0.1, 0.2]), np.array([1, 1, 0, 0])),
    "auc_saturated_bins": lambda M: _update(M.Auc(), np.array([1.0, 1.0]),
                                            np.array([1, 0])),
    "auc_random": lambda M: _update(
        M.Auc(num_thresholds=255),
        np.random.RandomState(1).rand(64),
        np.random.RandomState(2).randint(0, 2, 64)),
}


def _update(m, pred, label, compute=False):
    m.update(m.compute(pred, label)) if compute else m.update(pred, label)
    return m.accumulate(), m.name()


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics(case):
    j = METRIC_CASES[case](jp.metric)
    t = METRIC_CASES[case](tp.metric)
    np.testing.assert_allclose(np.asarray(t[0], np.float64),
                               np.asarray(j[0], np.float64), rtol=0,
                               atol=1e-12)
    assert t[1] == j[1]


def test_accuracy_functional_ties():
    """paddle.metric.accuracy ranks ties as lax.top_k: lower index first."""
    pred = np.array([[0.5, 0.5, 0.1], [0.2, 0.7, 0.7], [0.1, 0.2, 0.3]],
                    np.float32)
    for k, label in ((1, [1, 1, 2]), (2, [1, 0, 0]), (1, [0, 2, 2])):
        j = jp.metric.accuracy(jp.to_tensor(pred), jp.to_tensor(label), k=k)
        t = tp.metric.accuracy(tp.to_tensor(pred), tp.to_tensor(label), k=k)
        assert float(t.numpy()) == float(j.numpy())


# -------------------------------------------------------------- callbacks
def _callback_setup(pkg, net):
    rng = np.random.RandomState(0)
    x = rng.rand(32, 4).astype(np.float32)
    y = (x.sum(-1) > 2).astype(np.int64)
    ds = pkg.io.TensorDataset([pkg.to_tensor(x), pkg.to_tensor(y)])
    return pkg.hapi.Model(net), ds


def _callbacks_both(run):
    out = []
    for pkg, net in zip((jp, tp), _pair([4, 16, 2])):
        model, ds = _callback_setup(pkg, net)
        np.random.seed(0)
        out.append(run(pkg, model, net, ds))
    return out


def test_callback_hooks_fire_in_order():
    def run(pkg, model, net, ds):
        calls = []

        class Spy(pkg.hapi.Callback):
            def on_train_begin(self, logs=None):
                calls.append("train_begin")

            def on_epoch_begin(self, epoch, logs=None):
                calls.append(f"epoch_begin{epoch}")

            def on_train_batch_begin(self, step, logs=None):
                calls.append(f"batch_begin{step}")

            def on_train_batch_end(self, step, logs=None):
                calls.append(("batch", round(logs["loss"], 5)))

            def on_epoch_end(self, epoch, logs=None):
                calls.append((f"epoch_end{epoch}", round(logs["loss"], 5)))

            def on_train_end(self, logs=None):
                calls.append("train_end")

        model.prepare(pkg.optimizer.Adam(learning_rate=1e-2,
                                         parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        model.fit(ds, epochs=2, batch_size=16, verbose=0, callbacks=[Spy()])
        return calls
    j, t = _callbacks_both(run)
    assert t == j
    assert t[0] == "train_begin" and t[-1] == "train_end"
    assert sum(isinstance(c, tuple) and c[0] == "batch" for c in t) == 4


def test_early_stopping():
    def run(pkg, model, net, ds):
        model.prepare(pkg.optimizer.Adam(learning_rate=0.0,
                                         parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        es = pkg.hapi.EarlyStopping(monitor="loss", patience=1, verbose=0)
        hist = model.fit(ds, eval_data=ds, epochs=10, batch_size=16,
                         verbose=0, callbacks=[es])
        return hist, model.stop_training, es.wait, es.stopped_epoch, es.best
    (hj, *sj), (ht, *st) = _callbacks_both(run)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=TOL)
    assert st[:3] == sj[:3] and st[0] and st[1] >= 1
    assert abs(st[3] - sj[3]) <= TOL


def test_lr_scheduler_callback_steps():
    def run(pkg, model, net, ds):
        sched = pkg.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        model.prepare(pkg.optimizer.SGD(learning_rate=sched,
                                        parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        hist = model.fit(ds, epochs=2, batch_size=16, verbose=0,
                         callbacks=[pkg.hapi.LRScheduler(by_step=True)])
        return sched(), hist
    (lr_j, hj), (lr_t, ht) = _callbacks_both(run)
    assert lr_t == lr_j == 0.025   # 4 steps: halved twice
    np.testing.assert_allclose(ht, hj, rtol=0, atol=TOL)


def test_reduce_lr_on_plateau_callback():
    def run(pkg, model, net, ds):
        sched = pkg.optimizer.lr.ReduceOnPlateau(0.1, patience=0,
                                                 factor=0.5)
        model.prepare(pkg.optimizer.Adam(learning_rate=sched,
                                         parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        model.fit(ds, eval_data=ds, epochs=4, batch_size=16, verbose=0,
                  callbacks=[pkg.hapi.ReduceLROnPlateau(monitor="loss")])
        return sched(), sched.num_bad_epochs, sched.best
    j, t = _callbacks_both(run)
    assert t[:2] == j[:2]
    assert abs(t[2] - j[2]) <= TOL


def test_epoch_logs_namespaced():
    def run(pkg, model, net, ds):
        seen = {}

        class Spy(pkg.hapi.Callback):
            def on_epoch_end(self, epoch, logs=None):
                seen.update(logs or {})

        model.prepare(pkg.optimizer.Adam(learning_rate=1e-2,
                                         parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        model.fit(ds, eval_data=ds, epochs=1, batch_size=16, verbose=0,
                  callbacks=[Spy()])
        return seen
    j, t = _callbacks_both(run)
    assert sorted(t) == sorted(j) == ["eval_loss", "loss"]
    assert isinstance(t["loss"], float) and isinstance(t["eval_loss"], float)
    for k in j:
        assert abs(t[k] - j[k]) <= TOL


# ------------------------------------------------------------- io, samplers
@pytest.mark.parametrize("sampler", ["random", "random_replacement",
                                     "subset", "weighted", "batch_shuffle",
                                     "distributed", "random_split"])
def test_sampler_order_under_seeded_numpy(sampler):
    def draw(io):
        ds = io.TensorDataset([np.arange(20, dtype=np.float32)])
        np.random.seed(3)
        if sampler == "random":
            return list(io.RandomSampler(ds))
        if sampler == "random_replacement":
            return list(io.RandomSampler(ds, replacement=True,
                                         num_samples=30))
        if sampler == "subset":
            return list(io.SubsetRandomSampler([2, 5, 7, 11, 13]))
        if sampler == "weighted":
            return list(io.WeightedRandomSampler(np.arange(1, 21), 15))
        if sampler == "batch_shuffle":
            return list(io.BatchSampler(ds, shuffle=True, batch_size=6))
        if sampler == "distributed":
            s = io.DistributedBatchSampler(ds, 4, num_replicas=3, rank=1,
                                           shuffle=True)
            s.set_epoch(2)
            return list(s)
        return [list(s.indices) for s in io.random_split(ds, [7, 13])]
    assert draw(tp.io) == draw(jp.io)


def test_sampler_explicit_generator():
    ds = list(range(20))
    a = list(tp.io.RandomSampler(ds, generator=np.random.RandomState(5)))
    b = list(tp.io.RandomSampler(ds, generator=np.random.RandomState(5)))
    c = list(tp.io.RandomSampler(ds, generator=np.random.default_rng(5),
                                 replacement=True))
    assert a == b and sorted(a) == ds and len(c) == 20


def test_dataloader_batches_match():
    """Collation: numpy samples, scalar labels, Tensor samples, dicts."""
    x = np.random.RandomState(0).randn(10, 3).astype(np.float32)

    class DictDs:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"x": x[i], "k": int(i), "f": float(i) / 2}

    for make in (lambda io, pkg: io.TensorDataset([pkg.to_tensor(x)]),
                 lambda io, pkg: DictDs()):
        outs = []
        for pkg in (jp, tp):
            loader = pkg.io.DataLoader(make(pkg.io, pkg), batch_size=4,
                                       drop_last=False)
            outs.append([b for b in loader])
            assert len(loader) == 3
        for bj, bt in zip(*outs):
            if isinstance(bj, dict):
                assert sorted(bt) == sorted(bj)
                bj, bt = [bj[k] for k in sorted(bj)], [bt[k]
                                                      for k in sorted(bt)]
            for a, b in zip(bj, bt):
                np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()))
                assert b.numpy().dtype.kind == np.asarray(a.numpy()).dtype.kind


class _Alarm:
    """A time limit of its own for a test that forks workers."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        def on_alarm(*_):
            raise TimeoutError(f"exceeded {self.seconds} s")
        self._old = signal.signal(signal.SIGALRM, on_alarm)
        signal.alarm(self.seconds)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


def test_fit_with_two_workers_matches():
    """num_workers=2 (forked workers, prefetch on): the same history and
    evaluation as the JAX package's single-process fit, and no worker
    alive afterwards."""
    def run(pkg, net):
        model = pkg.hapi.Model(net)
        model.prepare(pkg.optimizer.AdamW(learning_rate=1e-2,
                                          parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        workers = 2 if pkg is tp else 0
        hist = model.fit(_xor_ds(pkg), batch_size=8, epochs=2, verbose=0,
                         shuffle=True, num_workers=workers)
        return hist, model.evaluate(_xor_ds(pkg), batch_size=8, verbose=0,
                                    num_workers=workers)
    with _Alarm(60):
        (hj, rj), (ht, rt) = _both(run)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=TOL)
    np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=0, atol=TOL)
    assert rt["acc"] == rj["acc"]
    assert not mp.active_children()


def test_prefetcher_teardown_stops_workers():
    ds = _xor_ds(tp, n=64)
    with _Alarm(60):
        loader = tp.io.DataLoader(ds, batch_size=4, num_workers=2)
        before = tp.io.prefetch.transfer_counts()
        inner = loader.iter(host=True)
        pf = tp.io.DevicePrefetcher(inner, depth=2)
        first = next(pf)
        assert inner.workers_alive == 2
        pf.close()
        assert pf.closed and inner.workers_alive == 0
        # what the producer had already placed may still come out; then
        # the closed prefetcher ends instead of waiting
        assert len(list(pf)) <= 2
        # abandoned mid-epoch: garbage collection reaps the workers
        inner = loader.iter(host=True)
        pf = tp.io.DevicePrefetcher(inner)
        next(pf)
        del pf
        gc.collect()
        assert inner.workers_alive == 0
        # a whole epoch through a prefetcher, then exhaustion
        with tp.io.DevicePrefetcher(loader.iter(host=True)) as pf:
            n = sum(1 for _ in pf)
        assert n == 16 and pf.closed
    assert not mp.active_children()
    assert first[0].shape == [4, 8] and first[1].shape == [4]
    after = tp.io.prefetch.transfer_counts()
    assert after["batches"] - before["batches"] >= 18


def test_goodput_and_sentinel_after_fit():
    """The ledger counts every train step, the sentinel observes each,
    and both packages agree on the counts (the clocks differ)."""
    def run(pkg, net):
        pkg.observability.goodput.reset_ledger()
        pkg.observability.sentinel.reset()
        model = pkg.hapi.Model(net)
        model.prepare(pkg.optimizer.Adam(learning_rate=1e-2,
                                         parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        model.fit(_xor_ds(pkg), batch_size=8, epochs=2, verbose=0)
        snap = pkg.observability.goodput.ledger().snapshot()
        sent = pkg.observability.sentinel.get().snapshot()
        pkg.observability.goodput.ledger().run_end()
        return (snap["steps"], snap["last_step"], sorted(snap["buckets"]),
                sent["observed_steps"], sent["counts"],
                abs(sum(snap["buckets"].values()) - snap["wall_s"]) < 1e-6)
    j, t = _both(run)
    assert t == j
    assert t[0] == 8 and t[3] == 8 and t[5]


def test_no_silent_cpu_without_cuda(monkeypatch):
    """With no device set the device is the card: the loader, the
    prefetcher and a ResNet raise without CUDA instead of running on the
    CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    ds = _xor_ds(tp)
    monkeypatch.setattr(tp.core.place, "_current", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.io.DataLoader(ds, batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.io.DevicePrefetcher(iter([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.vision.models.resnet18(num_classes=2)


# ------------------------------------------------- schedulers and optimizers
SCHEDULERS = {
    "NoamDecay": lambda lr: lr.NoamDecay(64, 5, learning_rate=2.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([3, 6], [1.0, 0.5, 0.1]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.5, 0.3),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.5, 0.3),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.5, 5, 0.01, 2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(
        0.5, 4, 0.01, 1.0, cycle=True),
    "LinearWarmup_inner": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(0.5, 6), 3, 0.0, 0.5),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.5, 0.8),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.5, [2, 5], 0.3),
    "StepDecay": lambda lr: lr.StepDecay(0.5, 3, 0.5),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.5, lambda e: 0.9 ** e),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(0.5, 7, 0.01),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(
        0.5, lambda e: 0.95),
    "OneCycleLR": lambda lr: lr.OneCycleLR(1.0, 12),
    "OneCycleLR_linear": lambda lr: lr.OneCycleLR(
        1.0, 10, anneal_strategy="linear"),
    "CyclicLR": lambda lr: lr.CyclicLR(0.1, 1.0, 3, mode="triangular2"),
    "CyclicLR_exp": lambda lr: lr.CyclicLR(0.1, 1.0, 2, 4,
                                           mode="exp_range", exp_gamma=0.9),
    "CosineAnnealingWarmRestarts": lambda lr:
        lr.CosineAnnealingWarmRestarts(0.5, 3, T_mult=2),
    "LinearLR": lambda lr: lr.LinearLR(0.5, 6, start_factor=0.25),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_schedulers(name):
    """Twelve steps (and one explicit epoch) of each of the JAX package's
    schedulers give the same rates; the state dict carries them."""
    def run(lr):
        s = SCHEDULERS[name](lr)
        rates = [s()]
        for _ in range(12):
            s.step()
            rates.append(s())
        s.step(epoch=4)
        rates.append(s())
        return rates, s
    (rj, sj), (rt, st) = run(jp.optimizer.lr), run(tp.optimizer.lr)
    np.testing.assert_allclose(rt, rj, rtol=1e-12, atol=0)
    fresh = SCHEDULERS[name](tp.optimizer.lr)
    fresh.set_state_dict(st.state_dict())
    assert fresh() == st()


def test_reduce_on_plateau_scheduler():
    def run(lr):
        s = lr.ReduceOnPlateau(1.0, patience=1, factor=0.5, cooldown=1)
        out = []
        for m in (1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8):
            s.step(m)
            out.append((s(), s.num_bad_epochs, s.cooldown_counter))
        return out
    assert run(tp.optimizer.lr) == run(jp.optimizer.lr)


def test_sgd_matches():
    """SGD with L2 weight decay, three steps on the MLP twins."""
    x = np.random.RandomState(4).randn(6, 8).astype(np.float32)
    y = np.array([0, 1, 1, 0, 1, 0])
    out = []
    for pkg, net in zip((jp, tp), _pair([8, 32, 2])):
        opt = pkg.optimizer.SGD(learning_rate=0.1, weight_decay=0.01,
                                parameters=net.parameters())
        losses = []
        for _ in range(3):
            loss = pkg.nn.functional.cross_entropy(net(pkg.to_tensor(x)),
                                                   pkg.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        out.append((losses, [np.asarray(p.numpy()) for p in
                             net.parameters()]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=0, atol=TOL)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
