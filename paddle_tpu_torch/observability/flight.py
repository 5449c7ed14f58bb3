"""Collective flight recorder: a per-group, sequence-stamped history of
the collectives this rank issued (counterpart of
``paddle_tpu/observability/flight.py``).

Paddle's comm task manager (paddle/phi/core/distributed/
comm_task_manager.cc) keeps a record of every collective a rank issued
(sequence number, op, shape) so that a multi-rank hang can be diagnosed
after the fact: diff the ranks' tails and the rank that stalled before,
or raced past, a collective names itself. This module is that record:

* every primitive of ``distributed/communication/collective.py`` stamps
  a per-group monotonic **sequence number** and appends
  ``(seq, op, shape, dtype, bytes, t0, t1)`` to a bounded ring (``begin``
  before the NCCL call, ``end`` when it returns or raises: a rank blocked
  inside a collective leaves a visibly unfinished entry);
* ``PADDLE_TPU_FLIGHT_RECORD=/path`` persists the ring to a rank-suffixed
  JSON file at process exit and from the watchdog's hang path (an
  ``os.abort`` skips atexit, so the watchdog dumps first). The payload is
  the JAX package's (``paddle_tpu.flight_record/1``): a dump of either
  package loads in the other;
* ``load_dumps`` + ``diff_ranks`` are the out-of-band desync detector:
  the watchdog gathers every rank's tail through the filesystem (the
  collectives themselves are what is stuck) and the diff names the rank
  that stalled before, or completed without, which sequence number.

The rank comes from the launcher's environment, never from NCCL
(``rank_world``): the watchdog asks for it while a collective is stuck.
Recording is gated by ``FLAGS_flight_recorder`` (default on: a
collective is a coarse operation, so a clock read and a deque append a
call are noise).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..core import flags

__all__ = ["FlightRecorder", "RECORDER", "enabled", "record_path",
           "dump", "load_dumps", "diff_ranks", "RECORD_ENV", "CAPACITY",
           "env_rank", "rank_world"]

flags.define_flag(
    "flight_recorder", True,
    "Record every collective's (seq, op, shape, bytes, t0, t1) into a "
    "bounded ring buffer for post-mortem hang/desync diagnosis.")

_enabled = {"on": bool(flags.get_flag("flight_recorder"))}
flags.on_change("flight_recorder",
                lambda v: _enabled.__setitem__("on", bool(v)))


def enabled() -> bool:
    return _enabled["on"]


#: env var naming the persistence path (rank-suffixed per process)
RECORD_ENV = "PADDLE_TPU_FLIGHT_RECORD"

#: ring capacity — enough to cover the deepest hybrid step (a 1F1B
#: pipeline step issues tens of p2p exchanges) many times over
CAPACITY = 2048


class FlightRecorder:
    """Bounded ring of collective records with per-group sequencing."""

    def __init__(self, capacity: int = CAPACITY):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq: Dict[int, int] = {}      # group id -> next sequence
        #: records whose completion a CUDA event will tell (end_on_device)
        self._pending: List[dict] = []

    def next_seq(self, group_id: int = 0) -> int:
        with self._lock:
            n = self._seq.get(group_id, 0)
            self._seq[group_id] = n + 1
            return n

    def begin(self, group_id: int, op: str, shape, dtype,
              nbytes: int, **extra) -> dict:
        """Append an in-flight record (t1 stays None until ``end``). The
        entry is in the ring at once: a rank that never returns from the
        collective leaves it unfinished on purpose. ``dtype`` may be a
        live dtype object: it is made a string at tail/dump time."""
        if self._pending:
            self._resolve()
        rec = {"seq": self.next_seq(group_id), "group": int(group_id),
               "op": op, "shape": list(shape or ()),
               "dtype": dtype, "bytes": int(nbytes),
               "t0": time.perf_counter(), "t1": None}
        if extra:
            rec.update(extra)
        with self._lock:
            self._ring.append(rec)
        return rec

    def end(self, rec: Optional[dict]):
        if rec is not None:
            rec["t1"] = time.perf_counter()

    def end_on_device(self, rec: Optional[dict], event):
        """Close ``rec`` when the CUDA ``event`` (recorded on a stream
        behind the collective) completes: its t1 is stamped when the
        completion is first seen (at a later ``begin``, ``tail``,
        ``open_entries`` or dump). Until then the record is in flight, as
        a collective NCCL has not finished on the card is."""
        if rec is None:
            return
        rec["_event"] = event
        with self._lock:
            self._pending.append(rec)

    def _resolve(self):
        with self._lock:
            pending = list(self._pending)
        done = []
        for rec in pending:
            ev = rec.get("_event")
            if ev is None or ev.query():
                rec.pop("_event", None)
                if rec.get("t1") is None:
                    rec["t1"] = time.perf_counter()
                done.append(rec)
        if done:
            with self._lock:
                self._pending = [r for r in self._pending
                                 if all(r is not d for d in done)]

    def open_entries(self) -> List[dict]:
        """Live in-flight records (t1 still None and not abandoned by an
        abort path). The dicts are the live ring entries, not copies."""
        if self._pending:
            self._resolve()
        with self._lock:
            return [r for r in self._ring
                    if r.get("t1") is None and "raised" not in r]

    def tail(self, n: int = 0) -> List[dict]:
        """Newest ``n`` records (all when n<=0) without clearing, as
        JSON-able copies (dtypes made strings)."""
        if self._pending:
            self._resolve()
        with self._lock:
            out = list(self._ring)
        out = [{k: v for k, v in r.items() if k != "_event"}
               for r in (out[-n:] if n > 0 else out)]
        for r in out:
            if not isinstance(r["dtype"], str):
                r["dtype"] = str(r["dtype"])
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._seq.clear()
            self._pending = []


#: process-global recorder the collective layer stamps into
RECORDER = FlightRecorder()


def env_rank() -> Optional[int]:
    """This process's trainer rank from the launcher's environment
    (``RANK``, else Paddle's ``PADDLE_TRAINER_ID``), or None outside a
    launcher. The profiler's trace names and the watchdog's count of
    peers come from the same reading."""
    v = os.environ.get("RANK") or os.environ.get("PADDLE_TRAINER_ID")
    return int(v) if v is not None else None


def rank_world():
    """(rank, world) from the launcher's environment (``RANK`` /
    ``WORLD_SIZE``, or ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``);
    (0, 1) outside a launcher. It never asks NCCL: the watchdog calls it
    while a collective is stuck."""
    rank = env_rank() or 0
    world = int(os.environ.get("WORLD_SIZE")
                or os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    return rank, world


_rank_world = rank_world      # pre-public-name alias


def record_path(base: Optional[str] = None,
                rank: Optional[int] = None) -> Optional[str]:
    """Per-rank dump path: ``<base>.r<rank>`` (every rank suffixed, rank 0
    included, so ``load_dumps`` can enumerate a complete set)."""
    base = base if base is not None else os.environ.get(RECORD_ENV)
    if not base:
        return None
    r = rank if rank is not None else _rank_world()[0]
    return f"{base}.r{r}"


def dump(path: Optional[str] = None, reason: str = "") -> Optional[str]:
    """Persist the ring to ``path`` (default: the rank-suffixed
    ``PADDLE_TPU_FLIGHT_RECORD`` path). Returns the written path, or
    None when no path is configured. Never raises — this runs from
    crash/hang paths."""
    try:
        path = path or record_path()
        if not path:
            return None
        rank, world = _rank_world()
        payload = {"format": "paddle_tpu.flight_record/1",
                   "rank": rank, "world": world, "pid": os.getpid(),
                   "reason": reason, "unix_time": time.time(),
                   "perf_counter": time.perf_counter(),
                   "entries": RECORDER.tail()}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def load_dumps(base: str, world: Optional[int] = None) -> Dict[int, dict]:
    """{rank: dump payload} for every ``<base>.r<rank>`` file present."""
    out: Dict[int, dict] = {}
    ranks = range(world) if world else range(256)
    for r in ranks:
        p = record_path(base, rank=r)
        if not p or not os.path.exists(p):
            if world is None and r > 8 and not out:
                break
            continue
        try:
            with open(p) as f:
                out[r] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def _last_seq(entries: List[dict], group: int) -> int:
    seqs = [e["seq"] for e in entries if e.get("group", 0) == group]
    return max(seqs) if seqs else -1


def diff_ranks(dumps: Dict[int, dict], world: Optional[int] = None) -> dict:
    """Cross-rank diff of flight dumps — the desync/stall verdict.

    Returns ``{"status", "rank", "seq", "op", "detail", "per_rank"}``:

    * ``desync`` — at one sequence number, ranks disagree on op / shape /
      dtype (the minority rank(s) are named), or one rank completed an
      entry its peers are still blocked inside (it raced ahead);
    * ``stall`` — a rank never issued a sequence number its peers are
      blocked in (it stalled before the collective), or sits unfinished
      in an entry its peers completed;
    * ``ok`` — tails agree over the comparable window.

    With ``world`` given, ranks with NO dump at all are treated as having
    issued nothing (last seq -1): a SIGKILLed peer leaves no file, and
    that absence is itself the verdict — the missing rank is named by the
    stall path instead of being silently excluded from the comparison.

    The ring is bounded, so only the overlapping seq window is compared;
    that is exactly the window a hang diagnosis needs (the tail).
    """
    if world is not None:
        dumps = dict(dumps)
        for r in range(world):
            dumps.setdefault(r, {"entries": []})
    if not dumps:
        return {"status": "ok", "detail": "no dumps to compare",
                "per_rank": {}}
    groups = sorted({e.get("group", 0) for d in dumps.values()
                     for e in d.get("entries", [])} or {0})
    per_rank = {r: {g: _last_seq(d.get("entries", []), g) for g in groups}
                for r, d in sorted(dumps.items())}
    for g in groups:
        by_rank = {r: {e["seq"]: e for e in d.get("entries", [])
                       if e.get("group", 0) == g}
                   for r, d in sorted(dumps.items())}
        last = {r: _last_seq(d.get("entries", []), g)
                for r, d in sorted(dumps.items())}
        hi = max(last.values())
        if hi < 0:
            continue
        # window every rank's ring still covers (rings are bounded)
        lo = max((min(m) for m in by_rank.values() if m), default=0)
        # 1) content mismatch at a shared sequence number
        for s in range(lo, hi + 1):
            sigs = {}
            for r, m in by_rank.items():
                e = m.get(s)
                if e is not None:
                    sigs.setdefault(
                        (e["op"], tuple(e["shape"]), e["dtype"]),
                        []).append(r)
            if len(sigs) > 1:
                maj = max(sigs.items(), key=lambda kv: len(kv[1]))
                for sig, ranks in sorted(sigs.items()):
                    if sig is not maj[0]:
                        op, shape, dtype = sig
                        mop, mshape, mdtype = maj[0]
                        return {
                            "status": "desync", "rank": ranks[0],
                            "seq": s, "op": op, "per_rank": per_rank,
                            "detail": (
                                f"rank {ranks[0]} issued "
                                f"{op}{list(shape)}/{dtype} at seq {s} "
                                f"where ranks {maj[1]} issued "
                                f"{mop}{list(mshape)}/{mdtype}")}
        # 2) position diff: a rank blocked inside an entry (pending) is
        # AT that seq; a rank whose newest entry completed is PAST its
        # last seq. The laggard/leader relative to the lowest blocked
        # position names the diverging rank.
        blocked = {}
        for r, m in by_rank.items():
            pend = [s for s, e in m.items() if e.get("t1") is None]
            if pend:
                blocked[r] = min(pend)
        if not blocked:
            continue        # no hang evidence in this group
        s_min = min(blocked.values())
        at_smin = sorted(r for r, s in blocked.items() if s == s_min)
        op = by_rank[at_smin[0]][s_min]["op"]
        behind = sorted(r for r, m in by_rank.items()
                        if r not in blocked and last[r] < s_min)
        ahead = sorted([r for r, s in blocked.items() if s > s_min]
                       + [r for r, m in by_rank.items()
                          if r not in blocked and last[r] >= s_min])
        if behind:
            return {"status": "stall", "rank": behind[0], "seq": s_min,
                    "op": op, "per_rank": per_rank,
                    "detail": (
                        f"rank {behind[0]} never issued seq {s_min} "
                        f"({op}) — ranks {at_smin} are blocked in it "
                        f"(rank {behind[0]} last seq "
                        f"{last[behind[0]]})")}
        if ahead:
            where = (f"is blocked at seq {blocked[ahead[0]]}"
                     if ahead[0] in blocked else
                     f"completed through seq {last[ahead[0]]}")
            return {"status": "desync", "rank": ahead[0], "seq": s_min,
                    "op": op, "per_rank": per_rank,
                    "detail": (
                        f"rank {ahead[0]} moved past seq {s_min} "
                        f"({op}) and {where}, while ranks {at_smin} "
                        f"are still blocked in seq {s_min} — rank "
                        f"{ahead[0]} desynced (bypassed or raced "
                        f"ahead)")}
        return {"status": "stall", "rank": None, "seq": s_min,
                "op": op, "per_rank": per_rank,
                "detail": (
                    f"all ranks are blocked inside seq {s_min} ({op}) "
                    f"— transport-level stall, no rank diverged")}
    return {"status": "ok", "per_rank": per_rank,
            "detail": "per-rank collective tails agree"}


def _exit_dump():
    """The exit dump, in a process that issued a collective: a process
    that issued none (the launcher, which imports the package too) must
    not overwrite rank 0's record with an empty ring."""
    if RECORDER._seq:
        dump(reason="atexit")


def _install_exit_dump():
    """Persist the ring at interpreter exit when PADDLE_TPU_FLIGHT_RECORD
    is set: it covers crashes that unwind (uncaught exceptions); the
    watchdog covers aborts that do not. Registered unconditionally:
    ``dump()`` reads the environment at exit, so setting the variable
    after import still produces a record (and an unset one is a no-op)."""
    import atexit
    atexit.register(_exit_dump)


_install_exit_dump()
