"""The port's metrics registry against the JAX package's.

The same operations (seeded with numpy: counters, gauges and histograms
with and without labels, label values that need escaping, a callback
gauge, values on bucket edges and past the last bucket) on a fresh
``MetricsRegistry`` of each package must give equal ``snapshot()``s
and equal Prometheus text; so must the errors of a wrong label set and
of a name registered twice as another kind. ``FLAGS_enable_metrics``
gates recording through ``on_change``'s hot mirror in both packages,
and with it off nothing is recorded and no clock is read.

Also ``paddle.metric``'s ``chunk_eval`` (IOB, IOE, IOBES and plain tags,
with and without ``seq_length`` and excluded chunk types) and
``DetectionMAP`` (integral and 11-point AP, difficult ground truths
counted or not, several updates) on numpy-seeded tags and boxes: equal
to the JAX package's (the counts exactly, precision, recall, F1 and mAP
within 1e-6).
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu.observability import metrics as jm
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.observability import metrics as tm

NAMES = ["paddle_tpu_test_requests", "paddle_tpu_test_depth",
         "paddle_tpu_test_latency_seconds"]
LABEL_VALUES = ["a", "b", 'quote"d', "back\\slash", "new\nline"]


def operations(seed, n=300):
    rng = np.random.RandomState(seed)
    edges = list(jm.DEFAULT_BUCKETS) + [100.0, 0.0]
    ops = []
    for _ in range(n):
        kind = rng.randint(6)
        label = LABEL_VALUES[rng.randint(len(LABEL_VALUES))]
        if kind == 0:
            ops.append(("counter", "inc", float(rng.randint(1, 5)), {}))
        elif kind == 1:
            ops.append(("lcounter", "inc", float(rng.randint(1, 5)),
                        {"outcome": label}))
        elif kind == 2:
            ops.append(("gauge", ("set", "inc", "dec")[rng.randint(3)],
                        float(rng.randint(-8, 9)) / 4, {}))
        elif kind == 3:
            ops.append(("lgauge", "set", float(rng.rand()),
                        {"replica": label, "phase": "decode"}))
        elif kind == 4:
            ops.append(("hist", "observe",
                        edges[rng.randint(len(edges))], {}))
        else:
            ops.append(("lhist", "observe", float(rng.exponential(0.01)),
                        {"phase": label}))
    return ops


def build(mod):
    reg = mod.MetricsRegistry()
    inst = {
        "counter": reg.counter(NAMES[0], "Requests."),
        "lcounter": reg.counter(NAMES[0] + "_by_outcome",
                                "Requests by outcome.",
                                labelnames=("outcome",)),
        "gauge": reg.gauge(NAMES[1], "Depth."),
        "lgauge": reg.gauge(NAMES[1] + "_share", "Share.",
                            labelnames=("replica", "phase")),
        "hist": reg.histogram(NAMES[2], "Latency."),
        "lhist": reg.histogram(NAMES[2] + "_by_phase", "",
                               labelnames=("phase",),
                               buckets=(0.001, 0.01, 0.1)),
    }
    reg.gauge("paddle_tpu_test_callback", "Callback.").set_function(
        lambda: 42.5)
    return reg, inst


def apply(inst, ops):
    for key, method, value, labels in ops:
        getattr(inst[key], method)(value, **labels)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_operations_same_snapshot_and_text(seed):
    ops = operations(seed)
    jpkg.set_flags({"FLAGS_enable_metrics": True})
    tpkg.set_flags({"FLAGS_enable_metrics": True})
    try:
        (jreg, jinst), (treg, tinst) = build(jm), build(tm)
        apply(jinst, ops)
        apply(tinst, ops)
    finally:
        jpkg.set_flags({"FLAGS_enable_metrics": False})
        tpkg.set_flags({"FLAGS_enable_metrics": False})
    snap = treg.snapshot()
    assert snap == jreg.snapshot()
    assert len(snap) == 7
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert tm.render_prometheus(snap) == jm.render_prometheus(snap)
    for key in ("counter", "lcounter"):
        assert tinst[key].total() == jinst[key].total()
    for key in ("hist", "lhist"):
        assert tinst[key].total_count() == jinst[key].total_count()
    assert tinst["gauge"].value() == jinst["gauge"].value()
    # reset zeroes the values and keeps the instruments
    treg.reset()
    jreg.reset()
    assert treg.snapshot() == jreg.snapshot()
    assert list(treg.snapshot()) == ["paddle_tpu_test_callback"]


def test_errors_match_jax():
    messages = []
    for mod in (jm, tm):
        reg, inst = build(mod)
        got = []
        with pytest.raises(ValueError) as err:
            inst["lcounter"]._label_values({"wrong": "x"})
        got.append(str(err.value))
        with pytest.raises(TypeError) as err:
            reg.gauge(NAMES[0])
        got.append(str(err.value))
        with pytest.raises(ValueError) as err:
            inst["lgauge"].set_function(lambda: 1.0)
        got.append(str(err.value))
        assert reg.counter(NAMES[0]) is inst["counter"]    # get-or-create
        messages.append(got)
    assert messages[1] == messages[0]


def test_disabled_path_records_nothing_and_reads_no_clock(monkeypatch):
    """Clock reads of this thread are counted (other threads, such as a
    test runner's, read the real clocks untouched)."""
    me = threading.get_ident()
    reads = []

    def counting(name, real):
        def clock():
            if threading.get_ident() == me:
                reads.append(name)
            return real()
        return clock

    reg, inst = build(tm)
    tpkg.set_flags({"FLAGS_enable_metrics": False})
    assert not tm.enabled()
    for name in ("monotonic", "perf_counter", "time"):
        monkeypatch.setattr(time, name, counting(name, getattr(time, name)))
    # not even the label check runs: the gate comes first
    inst["lcounter"].inc(1.0, wrong="label")
    apply(inst, operations(5, n=50))
    monkeypatch.undo()
    assert reads == []
    assert list(reg.snapshot()) == ["paddle_tpu_test_callback"]


def test_flag_mirror_follows_set_flags():
    seen = []
    tflags.on_change("FLAGS_enable_metrics", seen.append)
    try:
        for value, want in ((True, True), ("0", False), ("on", True),
                            (False, False)):
            tpkg.set_flags({"FLAGS_enable_metrics": value})
            assert tm.enabled() is want
    finally:
        tflags._observers["enable_metrics"].remove(seen.append)
    assert seen == [True, False, True, False]
    assert tpkg.get_flag("FLAGS_enable_metrics") is False
    assert tpkg.get_flag("reqtrace") is True       # the JAX default
    with pytest.raises(KeyError):
        tpkg.set_flags({"no_such_flag": 1})


# ------------------------------------------------ chunk_eval, DetectionMAP
_CHUNK_TAGS = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


@pytest.mark.parametrize("scheme", sorted(_CHUNK_TAGS))
@pytest.mark.parametrize("variant", ["full", "seq_length", "excluded"])
def test_chunk_eval(scheme, variant):
    import paddle_tpu.metric as jmetric
    import paddle_tpu_torch.metric as tmetric
    rng = np.random.RandomState(len(scheme))
    types = 3
    tags = types * _CHUNK_TAGS[scheme] + 1       # the last tag is O
    inp = rng.randint(0, tags, (5, 17))
    lab = np.where(rng.rand(5, 17) < 0.7, inp, rng.randint(0, tags, (5, 17)))
    kw = {}
    if variant == "seq_length":
        kw["seq_length"] = rng.randint(4, 18, 5)
    if variant == "excluded":
        kw["excluded_chunk_types"] = [1]
    with tpkg.device_guard("cpu"):
        got = tmetric.chunk_eval(inp, lab, scheme, types, **kw)
    ref = jmetric.chunk_eval(inp, lab, scheme, types, **kw)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r.numpy()),
                                   rtol=1e-6, atol=1e-6)
    assert int(got[3].numpy()[0]) > 0


def _detections(rng, n_img, classes):
    out = []
    for _ in range(n_img):
        g = rng.randint(1, 5)
        xy = rng.rand(g, 2) * 50
        gt = np.concatenate([rng.randint(0, classes, (g, 1)), xy,
                             xy + 5 + rng.rand(g, 2) * 20], 1)
        det = []
        for row in gt:
            jitter = rng.randn(4) * 2
            det.append([row[0], rng.rand(), *(row[1:] + jitter)])
        for _ in range(rng.randint(0, 3)):      # false positives
            xy = rng.rand(2) * 50
            det.append([rng.randint(0, classes), rng.rand(), *xy,
                        *(xy + 10)])
        out.append((np.asarray(det, np.float32), gt.astype(np.float32),
                    rng.rand(g) < 0.25))
    return out


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
@pytest.mark.parametrize("evaluate_difficult", [False, True])
def test_detection_map(ap_version, evaluate_difficult):
    import paddle_tpu.metric as jmetric
    import paddle_tpu_torch.metric as tmetric
    rng = np.random.RandomState(9)
    kw = dict(class_num=4, overlap_threshold=0.5,
              evaluate_difficult=evaluate_difficult, ap_version=ap_version)
    j, t = jmetric.DetectionMAP(**kw), tmetric.DetectionMAP(**kw)
    for det, gt, diff in _detections(rng, 6, 4):
        j.update(det, gt, diff)
        t.update(det, gt, diff)
    ref = j.accumulate()
    assert abs(t.accumulate() - ref) <= 1e-6
    assert 0.0 < ref <= 1.0
    t.reset()
    assert t.accumulate() == 0.0
