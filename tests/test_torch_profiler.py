"""The port's ``paddle.profiler`` and metrics CLI against the JAX
package's on the same programs.

The oracles are the JAX package's profiler tests
(``tests/test_observability.py``: the scheduler, the profiler's host
latency and sessions, the Chrome export, the CLI, a training loop with
everything on; ``tests/test_runtime_aux.py``'s profiler cases). The
device tracer (torch.profiler on the card) has no CPU run: here only
the host side records, and asking for the GPU target on a CUDA run is
the card check's business (``chip_smoke.py`` phase ``perf``).
"""
import json
import os
import time

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.observability import REGISTRY as J_REGISTRY
from paddle_tpu_torch import profiler
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.observability import REGISTRY, metrics, trace


@pytest.fixture(autouse=True)
def _hygiene(tmp_path, monkeypatch):
    # the JAX profiler starts its device trace under this directory
    monkeypatch.setenv("PADDLE_PROFILER_TRACE_DIR", str(tmp_path / "jax"))
    for pkg, reg in ((jp, J_REGISTRY), (tp, REGISTRY)):
        pkg.set_flags({"FLAGS_enable_metrics": False})
        reg.reset()
    trace.deactivate()
    trace.clear()
    with tp.device_guard("cpu"):
        yield
    for pkg, reg in ((jp, J_REGISTRY), (tp, REGISTRY)):
        pkg.set_flags({"FLAGS_enable_metrics": False})
        reg.reset()
    trace.deactivate()
    trace.clear()


GRID = [dict(closed=c, ready=r, record=rec, repeat=rep, skip_first=s)
        for c in (0, 1, 2) for r in (0, 1) for rec in (1, 3)
        for rep in (0, 1, 2) for s in (0, 3)]


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    f"{k[0]}{v}" for k, v in kw.items()))
def test_make_scheduler_same_states_as_jax(kw):
    want = jp.profiler.make_scheduler(**kw)
    got = profiler.make_scheduler(**kw)
    assert [got(i).name for i in range(24)] == \
        [want(i).name for i in range(24)]


def _train(pkg, steps=2, trace_dir=None, worker="t0", record=True):
    """A small Paddle-API model's forward, backward and SGD step under the
    package's Profiler; returns (profiler, op calls)."""
    pkg.seed(0)
    net = pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                            pkg.nn.Linear(16, 4), pkg.nn.Tanh())
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    x = pkg.to_tensor(np.random.RandomState(0).randn(4, 8)
                      .astype(np.float32))
    kw = {}
    if trace_dir is not None:
        kw["on_trace_ready"] = pkg.profiler.export_chrome_tracing(
            trace_dir, worker_name=worker)
    with pkg.profiler.Profiler(timer_only=not record, **kw) as p:
        for _ in range(steps):
            with pkg.profiler.RecordEvent("fwd"):
                loss = (net(x) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            p.step(num_samples=4)
    return p, {k: v["calls"] for k, v in p.op_stats().items()}


class TestProfilerParity:
    def test_op_stats_same_as_jax(self):
        _, want = _train(jp, record=False)
        p, got = _train(tp, record=False)
        assert got == want
        assert got["linear"] == 4
        stats = p.op_stats()
        assert all(v["total_s"] > 0 and v["max_s"] > 0
                   for v in stats.values())

    def test_chrome_export_same_as_jax(self, tmp_path):
        pj, _ = _train(jp, trace_dir=str(tmp_path / "j"))
        pt, _ = _train(tp, trace_dir=str(tmp_path / "t"))
        assert os.path.basename(pt.trace_path) == "t0_host_ops.json"
        docs = [json.load(open(p.trace_path)) for p in (pj, pt)]
        meta = [[e for e in d["traceEvents"] if e["ph"] == "M"]
                for d in docs]
        assert meta[1] == meta[0]
        assert {"name": "clock_sync", "ph": "M", "pid": 0,
                "args": {"rank": 0, "offset_vs_rank0_s": None}} in meta[1]
        events = [sorted((e["name"], e["cat"]) for e in d["traceEvents"]
                         if e["ph"] == "X") for d in docs]
        assert events[1] == events[0]
        evs = [e for e in docs[1]["traceEvents"] if e["ph"] == "X"]
        ts = [e["ts"] for e in evs]
        assert ts == sorted(ts) and all(e["dur"] >= 0 for e in evs)
        assert sum(1 for e in evs if e["name"] == "fwd") == 2
        # no card on this host: no device trace
        assert pt.device_trace_path is None

    def test_chrome_export_rank_name(self, tmp_path, monkeypatch):
        monkeypatch.setenv("RANK", "3")
        with profiler.Profiler(on_trace_ready=profiler.export_chrome_tracing(
                str(tmp_path))) as p:
            p.step()
        assert os.path.basename(p.trace_path) == "worker_r3_host_ops.json"
        meta = [e for e in json.load(open(p.trace_path))["traceEvents"]
                if e["name"] == "clock_sync"]
        assert meta[0]["args"] == {"rank": 3, "offset_vs_rank0_s": None}


class TestProfilerLatency:
    def test_summary_reports_real_host_time(self, capsys):
        net = tp.nn.Linear(8, 8)
        x = tp.to_tensor(np.random.randn(2, 8).astype(np.float32))
        with profiler.Profiler(timer_only=True) as p:
            for _ in range(3):
                net(x)
                p.step()
        stats = p.op_stats()
        assert stats["linear"]["calls"] == 3
        assert stats["linear"]["total_s"] > 0 and stats["linear"]["max_s"] > 0
        counts = p.summary(sorted_by="time")
        out = capsys.readouterr().out
        assert "total(ms)" in out and "avg(ms)" in out
        assert counts["linear"] == 3

    def test_summary_sort_orders(self):
        x = tp.to_tensor(np.ones((4, 4), np.float32))
        with profiler.Profiler(timer_only=True) as p:
            _ = x + x
            _ = x * x
            _ = x * x
        by_calls = list(p.summary(sorted_by=profiler.SortedKeys.Calls))
        assert by_calls[0] == "multiply"
        for key in profiler.SortedKeys:
            p.summary(sorted_by=key)
        with pytest.raises(ValueError):
            p.summary(sorted_by="bogus")

    def test_session_state_reset_on_restart(self):
        x = tp.to_tensor(np.ones((2, 2), np.float32))
        p = profiler.Profiler(timer_only=True)
        p.start()
        _ = x + x
        with profiler.RecordEvent("first_session"):
            pass
        p.stop()
        assert p._op_stats and p._events
        p.start()
        assert not p._op_stats and not p._events and p._step == 0
        _ = x * x
        p.stop()
        assert "add" not in p._op_stats
        assert all(name != "first_session" for name, _, _ in p._events)

    def test_step_timer_and_metrics(self):
        tp.set_flags({"FLAGS_enable_metrics": True})
        with profiler.Profiler(timer_only=True) as p:
            for _ in range(3):
                time.sleep(0.002)
                p.step(num_samples=16)
        assert len(p._step_times) == 3
        info = p.step_info()
        assert "steps/sec" in info and "steps: 3" in info
        assert REGISTRY.get("paddle_tpu_train_steps_total").total() == 3
        assert REGISTRY.get("paddle_tpu_steps_per_second").value() > 0
        assert REGISTRY.get("paddle_tpu_examples_per_second").value() > 0

    def test_step_info_examples_per_sec_uses_num_samples(self):
        with profiler.Profiler(timer_only=True) as p:
            for _ in range(2):
                time.sleep(0.002)
                p.step(num_samples=100)
        info = p.step_info()
        ips = float(info.split("steps/sec: ")[1].split()[0])
        eps = float(info.split("examples/sec: ")[1].split()[0])
        assert eps == pytest.approx(100 * ips, rel=0.05)
        assert profiler.Profiler().step_info() == "no steps recorded"

    def test_hook_unregistered_after_stop(self):
        before = len(dispatch._op_hooks)
        with profiler.Profiler(timer_only=True):
            assert len(dispatch._op_hooks) == before + 1
        assert len(dispatch._op_hooks) == before

    def test_record_event_outside_a_session_goes_to_the_trace(self):
        trace.clear()
        trace.activate()
        try:
            with profiler.RecordEvent("loose"):
                pass
        finally:
            trace.deactivate()
        assert [(n, c) for n, c, *_ in trace.drain()] == [("loose", "user")]

    def test_scheduler_window_records_only_its_steps(self):
        x = tp.to_tensor(np.ones((2, 2), np.float32))
        with profiler.Profiler(scheduler=profiler.make_scheduler(
                closed=1, ready=1, record=2, repeat=1),
                timer_only=True) as p:
            for _ in range(5):
                _ = x + x
                p.step()
        assert p.op_stats()["add"]["calls"] == 2
        with profiler.Profiler(scheduler=(1, 3), timer_only=True) as p:
            for _ in range(5):
                _ = x + x
                p.step()
        assert p.op_stats()["add"]["calls"] == 2

    def test_record_event_kept_in_the_record_window_only(self, tmp_path):
        # closed 1, ready 1, record 2: the ranges of steps 2 and 3 only
        with profiler.Profiler(
                scheduler=profiler.make_scheduler(closed=1, ready=1,
                                                  record=2, repeat=1),
                on_trace_ready=profiler.export_chrome_tracing(
                    str(tmp_path))) as p:
            for i in range(5):
                with profiler.RecordEvent(f"step{i}"):
                    pass
                p.step()
        assert [name for name, _, _ in p._events] == ["step2", "step3"]
        names = {e["name"] for e in json.load(open(p.trace_path))[
            "traceEvents"] if e.get("cat") == "user"}
        assert names == {"step2", "step3"}

    def test_span_overflow_marked_in_trace(self, tmp_path, monkeypatch):
        monkeypatch.setattr(trace, "MAX_EVENTS", 4)
        with pytest.warns(UserWarning, match="span buffer overflowed"):
            with profiler.Profiler(
                    on_trace_ready=profiler.export_chrome_tracing(
                        str(tmp_path))) as p:
                x = tp.to_tensor(np.ones((2, 2), np.float32))
                for _ in range(10):
                    _ = x + x
                p.step()
        assert p._spans_dropped > 0
        doc = json.load(open(p.trace_path))
        marker = [e for e in doc["traceEvents"]
                  if e["name"] == "spans_dropped"]
        assert marker and marker[0]["args"]["count"] == p._spans_dropped

    def test_profile_context_manager(self):
        x = tp.to_tensor(np.ones((2, 2), np.float32))
        with profiler.profile(timer_only=True) as p:
            _ = x - x
        assert p.op_stats()["subtract"]["calls"] == 1


# ---------------------------------------------------------------------------
# the metrics CLI
# ---------------------------------------------------------------------------
def _snap(value, labeled=False):
    labels = ["x"] if labeled else []
    return {"m_total": {"kind": "counter", "help": "a test counter",
                        "labelnames": ["op"] if labeled else [],
                        "series": [{"labels": labels, "value": value}]}}


class TestCLI:
    def test_dump_live_prometheus(self, capsys):
        from paddle_tpu_torch.observability.__main__ import main
        assert main([]) == 0
        out = capsys.readouterr().out
        assert "paddle_tpu_device_live_bytes" in out
        # with metrics on, the census refresh fills the memory gauges
        tp.set_flags({"FLAGS_enable_metrics": True})
        assert main([]) == 0
        assert 'paddle_tpu_hbm_live_bytes{tag="params"}' in \
            capsys.readouterr().out

    @pytest.mark.parametrize("fmt", [[], ["--format", "json"]])
    def test_input_same_as_jax(self, tmp_path, capsys, fmt):
        from paddle_tpu.observability.__main__ import main as jmain
        from paddle_tpu_torch.observability.__main__ import main as tmain
        tp.set_flags({"FLAGS_enable_metrics": True})
        metrics.counter("test_cli_total", "from a run",
                        labelnames=("op",)).inc(op="x")
        metrics.histogram("test_cli_seconds", "a histogram").observe(0.01)
        snap_file = tmp_path / "snap.json"
        snap_file.write_text(json.dumps(REGISTRY.snapshot()))
        outs = []
        for main in (jmain, tmain):
            assert main(["--input", str(snap_file)] + fmt) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0]
        assert "test_cli_total" in outs[1]
        assert tmain(["--input", str(tmp_path / "missing.json")]) == 1

    def test_merge_same_as_jax(self, tmp_path, capsys):
        from paddle_tpu.observability.__main__ import main as jmain
        from paddle_tpu_torch.observability.__main__ import main as tmain
        base = str(tmp_path / "metrics.json")
        json.dump(_snap(1, labeled=True), open(base, "w"))
        json.dump(_snap(2, labeled=True), open(base + ".rank1", "w"))
        json.dump(_snap(3, labeled=True), open(base + ".rank2.pid77", "w"))
        json.dump({"s": {"kind": "gauge", "help": "", "labelnames": ["rank"],
                         "series": [{"labels": ["1"], "value": 0.5}]}},
                  open(base + ".pid9", "w"))
        open(base + ".rank5", "w").write("{truncated")
        outs = []
        for main in (jmain, tmain):
            for fmt in ([], ["--format", "json"]):
                assert main(["--merge", base] + fmt) == 0
                outs.append(capsys.readouterr().out)
        assert outs[2:] == outs[:2]
        assert 'm_total{rank="1",op="x"} 2' in outs[2]
        assert 's{proc="pid9",rank="1"} 0.5' in outs[2]
        out = str(tmp_path / "merged.prom")
        assert tmain(["--merge", base, "--output", out]) == 0
        assert open(out).read() == outs[2]
        assert tmain(["--merge", str(tmp_path / "nope.json")]) == 1


# ---------------------------------------------------------------------------
# one short training loop, everything on
# ---------------------------------------------------------------------------
def test_training_loop_full_telemetry(tmp_path):
    tp.set_flags({"FLAGS_enable_metrics": True})
    net = tp.nn.Linear(16, 4)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    with profiler.Profiler(on_trace_ready=profiler.export_chrome_tracing(
            str(tmp_path))) as p:
        for _ in range(3):
            x = tp.to_tensor(np.random.randn(8, 16).astype(np.float32))
            loss = (net(x) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            p.step(num_samples=8)
    assert any(v["total_s"] > 0 for v in p.op_stats().values())
    cats = {e.get("cat") for e in json.load(open(p.trace_path))[
        "traceEvents"]}
    assert "dispatch" in cats
    snap = REGISTRY.snapshot()
    assert "paddle_tpu_dispatch_op_latency_seconds" in snap
    assert "paddle_tpu_train_steps_total" in snap
    assert REGISTRY.get("paddle_tpu_steps_per_second").value() > 0
