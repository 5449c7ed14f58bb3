"""The port's collective flight recorder (``observability/flight.py``),
its wiring in the collectives and the watchdog, against the JAX
package's.

The oracles are the JAX package's ``tests/test_fleet_observability.py``
cases ``TestFlightRecorder``, ``TestDiffRanks`` and
``TestWatchdogFlight``: the ring's sequencing, tail, open entries and
wrap on the same records; dumps that load in either package; the same
diff verdicts; the collectives stamping the ring at a gloo world of one.
Then a two-process gloo desync drill through the port's launcher: rank 1
skips one ``all_reduce`` (``collective.desync``), both watchdogs
(``abort_on_hang``) dump, wait for each other's record and diff, and the
job ends with the desync exit code.
"""
import io
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import paddle_tpu_torch as tp
from paddle_tpu.observability import flight as jflight
from paddle_tpu_torch.distributed.communication import collective as C
from paddle_tpu_torch.distributed.watchdog import Watchdog
from paddle_tpu_torch.fault import inject, supervisor
from paddle_tpu_torch.observability import flight
from torch_dist_harness import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMES = ("t0", "t1")


def _records(rec):
    """One sequence of records: begins, ends (some left open), groups."""
    out = []
    for i, (g, op, shape) in enumerate([
            (0, "all_reduce", (4,)), (0, "barrier", ()),
            (7, "all_gather", (2,)), (0, "broadcast", (3, 3)),
            (7, "all_reduce", (1,)), (0, "all_reduce", (8,))]):
        e = rec.begin(g, op, shape, "float32", 4 * int(np.prod(shape)))
        if i not in (2, 5):                 # two stay in flight
            rec.end(e)
        out.append(e)
    return out


def _no_times(entries):
    return [{k: v for k, v in e.items() if k not in _TIMES}
            | {"open": e["t1"] is None} for e in entries]


class TestFlightRecorder:
    def test_ring_same_as_jax(self):
        j, t = jflight.FlightRecorder(), flight.FlightRecorder()
        je, te = _records(j), _records(t)
        assert [(e["seq"], e["group"]) for e in te] == \
            [(e["seq"], e["group"]) for e in je] == \
            [(0, 0), (1, 0), (0, 7), (2, 0), (1, 7), (3, 0)]
        assert _no_times(t.tail()) == _no_times(j.tail())
        assert _no_times(t.tail(2)) == _no_times(j.tail(2))
        assert _no_times(t.open_entries()) == _no_times(j.open_entries())
        assert [e["op"] for e in t.open_entries()] == ["all_gather",
                                                      "all_reduce"]
        assert t.next_seq(7) == j.next_seq(7) == 2
        t.clear()
        assert t.tail() == [] and t.next_seq(0) == 0

    @pytest.mark.parametrize("capacity,n", [(8, 20), (4, 4), (3, 10)])
    def test_ring_wraps_as_jax(self, capacity, n):
        j = jflight.FlightRecorder(capacity=capacity)
        t = flight.FlightRecorder(capacity=capacity)
        for r in (j, t):
            for _ in range(n):
                r.end(r.begin(0, "op", (1,), "f", 1))
        assert _no_times(t.tail()) == _no_times(j.tail())
        assert [e["seq"] for e in t.tail()] == list(range(n - capacity, n)) \
            if n > capacity else list(range(n))

    def test_raised_entry_is_not_open(self):
        t = flight.FlightRecorder()
        e = t.begin(0, "all_reduce", (4,), "float32", 16)
        e["raised"] = "ValueError"
        assert t.open_entries() == []

    def test_device_completion_closes_on_first_sight(self):
        class Event:
            done = False

            def query(self):
                return self.done

        t = flight.FlightRecorder()
        e = t.begin(0, "all_reduce", (4,), "float32", 16)
        ev = Event()
        t.end_on_device(e, ev)
        assert t.tail()[0]["t1"] is None and "_event" not in t.tail()[0]
        assert t.open_entries() == [e]
        ev.done = True
        t.begin(0, "barrier", (), "float32", 4)   # a later call sees it
        assert e["t1"] is not None and "_event" not in e
        assert [x["op"] for x in t.open_entries()] == ["barrier"]


class TestDumps:
    def test_dump_and_load_roundtrip(self, tmp_path):
        base = str(tmp_path / "flight.json")
        flight.RECORDER.clear()
        flight.RECORDER.end(
            flight.RECORDER.begin(0, "all_reduce", (4,), "float32", 16))
        path = flight.dump(path=flight.record_path(base, rank=0),
                           reason="test")
        assert path.endswith(".r0") and os.path.exists(path)
        dumps = flight.load_dumps(base, world=1)
        assert dumps[0]["reason"] == "test"
        assert dumps[0]["format"] == "paddle_tpu.flight_record/1"
        assert dumps[0]["entries"][0]["op"] == "all_reduce"
        flight.RECORDER.clear()

    def test_dump_without_env_is_noop(self, monkeypatch):
        monkeypatch.delenv(flight.RECORD_ENV, raising=False)
        assert flight.dump() is None

    def test_dumps_cross_both_ways(self, tmp_path):
        base = str(tmp_path / "flight.json")
        for r, (mod, rec) in enumerate(((jflight, jflight.RECORDER),
                                        (flight, flight.RECORDER))):
            rec.clear()
            _records(rec)
            mod.dump(path=mod.record_path(base, rank=r), reason=f"r{r}")
        j = jflight.load_dumps(base, world=2)
        t = flight.load_dumps(base, world=2)
        assert sorted(j) == sorted(t) == [0, 1]
        for r in (0, 1):
            assert _no_times(t[r]["entries"]) == _no_times(j[r]["entries"])
        assert flight.diff_ranks(t) == jflight.diff_ranks(j)
        for rec in (jflight.RECORDER, flight.RECORDER):
            rec.clear()

    def test_rank_world_from_the_launcher_env(self, monkeypatch):
        for var in ("RANK", "WORLD_SIZE", "PADDLE_TRAINER_ID",
                    "PADDLE_TRAINERS_NUM"):
            monkeypatch.delenv(var, raising=False)
        assert flight.rank_world() == (0, 1) and flight.env_rank() is None
        monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
        assert flight.rank_world() == (2, 4)
        monkeypatch.setenv("RANK", "3")
        monkeypatch.setenv("WORLD_SIZE", "8")
        assert flight.rank_world() == (3, 8)
        assert flight.record_path("/x/f.json") == "/x/f.json.r3"
        from paddle_tpu_torch.observability import goodput, reqtrace
        assert reqtrace.rank_world() == (3, 8)
        assert goodput.record_path("/x/g.json") == "/x/g.json.r3"


def _entry(seq, op="barrier", shape=(), dtype="float32", t1=1.0, group=0):
    return {"seq": seq, "group": group, "op": op, "shape": list(shape),
            "dtype": dtype, "bytes": 4, "t0": 0.5, "t1": t1}


def _dump(entries, rank=0, world=4):
    return {"rank": rank, "world": world, "entries": entries}


def _case(name):
    if name == "agreeing":
        return {r: _dump([_entry(0), _entry(1)]) for r in range(4)}
    if name == "empty":
        return {}
    if name == "all_blocked":
        return {r: _dump([_entry(0), _entry(1, t1=None)]) for r in range(4)}
    if name == "content_mismatch":
        d = {r: _dump([_entry(0, op="all_reduce", shape=(8,))])
             for r in (0, 1, 3)}
        d[2] = _dump([_entry(0, op="all_gather", shape=(4,))])
        return d
    d = {r: _dump([_entry(0), _entry(1, t1=None)]) for r in (0, 1, 3)}
    d[2] = {"stall": _dump([_entry(0)]),
            "raced": _dump([_entry(0), _entry(1)]),
            "blocked_ahead": _dump([_entry(0), _entry(1),
                                    _entry(2, op="all_reduce", t1=None)]),
            "missing": None}[name]
    if d[2] is None:
        del d[2]
    return d


class TestDiffRanks:
    @pytest.mark.parametrize("name,status,rank,seq", [
        ("agreeing", "ok", None, None), ("empty", "ok", None, None),
        ("stall", "stall", 2, 1), ("raced", "desync", 2, 1),
        ("blocked_ahead", "desync", 2, 1),
        ("content_mismatch", "desync", 2, 0),
        ("all_blocked", "stall", None, 1),
        ("missing", "stall", 2, 1)])
    def test_same_verdict_as_jax(self, name, status, rank, seq):
        world = 4 if name == "missing" else None
        v = flight.diff_ranks(_case(name), world=world)
        assert v == jflight.diff_ranks(_case(name), world=world)
        assert v["status"] == status
        assert v.get("rank") == rank and v.get("seq") == seq
        if rank is not None:
            assert f"rank {rank}" in v["detail"]


# ---------------------------------------------------------------------------
# the collectives at a gloo world of one
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world_of_one():
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.communication.group import \
        destroy_process_group
    with tp.device_guard("cpu"):
        tp.distributed.init_parallel_env()
        assert dist.get_world_size() == 1
        yield
        destroy_process_group()


@pytest.fixture
def ring(world_of_one):
    flight.RECORDER.clear()
    inject.disarm_all()
    with tp.device_guard("cpu"):
        yield flight.RECORDER
    tp.set_flags({"FLAGS_flight_recorder": True})
    flight.RECORDER.clear()
    inject.disarm_all()


class TestCollectivesStamp:
    def test_collectives_stamp_the_ring(self, ring):
        t = tp.to_tensor(np.ones(4, np.float32))
        C.all_reduce(t)
        C.barrier()
        tail = ring.tail()
        assert [e["op"] for e in tail] == ["all_reduce", "barrier"]
        assert [e["seq"] for e in tail] == [0, 1]
        assert tail[0]["shape"] == [4] and tail[0]["bytes"] == 16
        assert tail[0]["dtype"] == "float32"
        assert tail[1]["shape"] == [] and tail[1]["bytes"] == 4
        assert all(e["t1"] is not None for e in tail)

    def test_async_record_closes_at_wait(self, ring):
        t = tp.to_tensor(np.ones(4, np.float32))
        task = C.all_reduce(t, sync_op=False)
        task.wait()
        assert ring.tail()[0]["t1"] is not None

    def test_flag_disables_recording(self, ring):
        tp.set_flags({"FLAGS_flight_recorder": False})
        C.all_reduce(tp.to_tensor(np.ones(2, np.float32)))
        assert ring.tail() == []

    def test_desync_bypass_marks_entry(self, ring):
        t = tp.to_tensor(np.asarray([3.0], np.float32))
        with inject.armed("collective.desync", op="all_reduce"):
            C.all_reduce(t)
        e = ring.tail(1)[0]
        assert e["op"] == "all_reduce" and e.get("bypassed") is True
        assert e["t1"] is not None
        with inject.armed("collective.desync", op="all_reduce"):
            C.barrier()                  # the op filter: passes untouched
        assert ring.tail(1)[0].get("bypassed") is None
        out = []
        with inject.armed("collective.desync"):
            C.all_gather(out, t)
        assert ring.tail(1)[0]["bypassed"] and len(out) == 1

    def test_raised_collective_closes_entry(self, ring):
        t = tp.to_tensor(np.ones(4, np.float32))
        with pytest.raises(ValueError):
            C.all_reduce(t, op="not-a-reduce-op")
        e = ring.tail(1)[0]
        assert e["op"] == "all_reduce" and e["t1"] is not None
        assert e["raised"] == "ValueError"
        assert ring.open_entries() == []


class TestWatchdogFlight:
    def test_dump_diagnostics_persists_flight_record(self, ring, tmp_path,
                                                     monkeypatch):
        base = str(tmp_path / "flight.json")
        monkeypatch.setenv(flight.RECORD_ENV, base)
        C.all_reduce(tp.to_tensor(np.ones(4, np.float32)))
        buf = io.StringIO()
        Watchdog(timeout=60.0).dump_diagnostics(file=buf)
        out = buf.getvalue()
        assert "collective flight tail" in out
        assert "seq=0" in out and "all_reduce" in out
        assert "last collective: 'all_reduce'" in out
        assert os.path.exists(flight.record_path(base))
        dumps = flight.load_dumps(base, world=1)
        assert dumps[0]["entries"][0]["op"] == "all_reduce"

    def test_dump_diagnostics_without_env(self, ring, monkeypatch):
        monkeypatch.delenv(flight.RECORD_ENV, raising=False)
        buf = io.StringIO()
        Watchdog(timeout=60.0).dump_diagnostics(file=buf)
        assert "flight tail" in buf.getvalue()

    def test_op_hook_heartbeat_and_abort_code(self, ring, monkeypatch):
        codes = []
        monkeypatch.setitem(supervisor._exit, "fn", codes.append)
        wd = Watchdog(timeout=0.2, poll_interval=0.05,
                      abort_on_hang=True).start()
        try:
            x = tp.to_tensor(np.ones(2, np.float32))
            _ = x + x
            assert wd.last_op == "add"
            with wd:
                time.sleep(0.6)
        finally:
            wd.stop()
        assert wd.hang_count >= 1
        assert codes and codes[0] == supervisor.EXIT_WATCHDOG_HANG

    def test_start_and_stop_watchdog(self):
        from paddle_tpu_torch.distributed import watchdog
        from paddle_tpu_torch.core import dispatch
        before = len(dispatch._op_hooks)
        wd = watchdog.start_watchdog(timeout=30.0, poll_interval=0.05)
        try:
            assert watchdog.start_watchdog(timeout=30.0) is wd
            with pytest.warns(UserWarning):
                watchdog.start_watchdog(timeout=5.0)
            assert len(dispatch._op_hooks) == before + 1
        finally:
            watchdog.stop_watchdog()
        assert len(dispatch._op_hooks) == before


# ---------------------------------------------------------------------------
# two gloo processes: rank 1 skips one all_reduce
# ---------------------------------------------------------------------------
_DRILL = textwrap.dedent("""
    import time
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.watchdog import Watchdog
    from paddle_tpu_torch.fault import inject

    paddle.set_device("cpu")
    dist.init_parallel_env()
    rank = dist.get_rank()
    wd = Watchdog(timeout=3.0, poll_interval=0.25, abort_on_hang=True)
    wd.start()
    t = paddle.to_tensor(np.ones(4, np.float32))
    for _ in range(3):
        dist.all_reduce(t)
    if rank == 1:
        inject.arm("collective.desync", op="all_reduce")
    with wd:                     # work in flight from here on
        dist.all_reduce(t)       # rank 1 skips it: rank 0 blocks inside
        time.sleep(120)          # rank 1 waits here, issuing nothing
""")


def test_two_process_desync_drill(tmp_path):
    script = tmp_path / "drill.py"
    script.write_text(_DRILL)
    base = str(tmp_path / "flight.json")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env[flight.RECORD_ENV] = base
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master", f"127.0.0.1:{free_port()}",
         "--log_dir", str(tmp_path / "log"), "--abort_grace", "10",
         str(script)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=30)
    logs = {r: (tmp_path / "log" / f"workerlog.{r}").read_text()
            for r in (0, 1)}
    assert proc.returncode == supervisor.EXIT_DESYNC, (proc.stderr, logs)
    for r in (0, 1):
        assert "status=desync rank=1 seq=3" in logs[r], logs[r]
    # rank 1 waits outside any collective and ends itself; rank 0 ends
    # itself too, unless rank 1's exit ended its blocked all_reduce first
    assert "force exit code=119" in logs[1]
    assert "force exit code=119" in logs[0] or \
        "Connection closed by peer" in logs[0]
    dumps = flight.load_dumps(base, world=2)
    last = {r: dumps[r]["entries"][-1] for r in (0, 1)}
    assert last[1]["seq"] == 3 and last[1]["bypassed"] is True
    # rank 0 was still inside seq 3 when its watchdog fired; the
    # collective may have raised since, once rank 1's process ended
    assert last[0]["seq"] == 3 and last[0]["op"] == "all_reduce"
    assert last[0]["t1"] is None or "raised" in last[0]
    assert time.monotonic() - t0 < 30
