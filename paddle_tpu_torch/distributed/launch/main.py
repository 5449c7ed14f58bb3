"""The job launcher (counterpart of
``paddle_tpu/distributed/launch/main.py``).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        --master host:port [--log_dir D] script.py [args ...]

Starts ``nproc_per_node`` processes of ``script.py`` on this host (one
host: multi-host jobs come with the fault-tolerance slice), one a card,
each with the JAX launcher's environment (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``, ``PADDLE_MASTER``) and
torch's (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), which ``init_parallel_env`` reads. With ``--log_dir``
each rank's output goes to ``<log_dir>/workerlog.<rank>``. When a rank
ends with a non-zero code, the others get ``--abort_grace`` seconds to
end by themselves (a collective that lost a peer times out), then are
terminated, and the launcher exits with the code of the rank that
failed first (128 + the signal for a rank killed by one), not of a peer
that failed because it was gone. A failing rank is gone to its peers
before the launcher sees it end (its exit closes its connections, then
the interpreter and torch take most of a second to tear down), so the
peers' errors can reach the launcher first; they end with Python's
generic code 1 (an uncaught collective error) or a signal. So the
choice is made with the failures of the whole grace window, as the JAX
launcher re-selects with the full picture: the first that ended with a
code above 1 (a program's own ``sys.exit``), else the first. Restarts
(``--max_restarts``) belong to the fault-tolerance slice and raise.
"""
from __future__ import annotations

import argparse
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

FAULT_TOLERANCE_SLICE = ("group restarts and elastic training are a later "
                         "slice of the port (fault tolerance: "
                         "launch/elastic.py, kv_server)")


def _parse(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch one process a card on this host")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="processes on this host (default: its card count)")
    p.add_argument("--master", default=os.environ.get(
        "PADDLE_MASTER", "127.0.0.1:8765"), help="rendezvous host:port")
    p.add_argument("--log_dir", default=None,
                   help="write rank r's output to <log_dir>/workerlog.<r>")
    p.add_argument("--max_restarts", type=int, default=0)
    p.add_argument("--abort_grace", type=float, default=10.0,
                   help="seconds the other ranks get to end by themselves "
                        "after one failed, before they are terminated")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.max_restarts:
        raise NotImplementedError(f"--max_restarts: {FAULT_TOLERANCE_SLICE}")
    host, _, port = args.master.rpartition(":")
    if not host or not port.isdigit():
        p.error(f"--master must be host:port, got {args.master!r}")
    if args.nproc_per_node is None:
        import torch
        args.nproc_per_node = max(torch.cuda.device_count(), 1)
    if args.nproc_per_node < 1:
        p.error("--nproc_per_node must be at least 1")
    return args


def worker_env(args, local_rank: int, base: Optional[dict] = None) -> dict:
    """The environment of rank ``local_rank`` (one host: local rank =
    rank)."""
    world = args.nproc_per_node
    rank = local_rank
    host, _, port = args.master.rpartition(":")
    env = dict(os.environ if base is None else base)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_RANK_IN_NODE": str(local_rank),
        "PADDLE_MASTER": args.master,
        "RANK": str(rank),
        "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(args.nproc_per_node),
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
    })
    return env


def _exit_code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


def _cause(failures: List[Tuple[int, int]]) -> Tuple[int, int]:
    """(rank, code) of the failure the others followed, from the failures
    in the order they ended: the first with a code above 1, else the
    first."""
    return next((f for f in failures if f[1] > 1), failures[0])


def _end(procs: List[subprocess.Popen], grace: float = 5.0):
    """Terminate the live processes (their whole sessions), then kill what
    is left after ``grace`` seconds."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def launch(argv=None) -> int:
    """Start the ranks and wait: 0 when every rank ends with 0, else the
    code of the first rank that failed."""
    args = _parse(argv)
    logs, procs = [], []
    cmd = [sys.executable, "-u", args.training_script,
           *args.training_script_args]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    stop = {"signal": None}

    def on_signal(signum, frame):
        stop["signal"] = signum
    old = {s: signal.signal(s, on_signal)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for local in range(args.nproc_per_node):
            out = None
            if args.log_dir:
                out = open(os.path.join(args.log_dir, f"workerlog.{local}"),
                           "wb")
                logs.append(out)
            procs.append(subprocess.Popen(
                cmd, env=worker_env(args, local), stdout=out,
                stderr=subprocess.STDOUT if out else None,
                start_new_session=True))
        # one waiter a rank records the order the ranks end in: the first
        # failure is the cause, the peers' failures that follow are effects
        ended = queue.Queue()
        for rank, p in enumerate(procs):
            threading.Thread(target=lambda r=rank, q=p: ended.put(
                (r, q.wait())), daemon=True).start()
        failures, left, deadline = [], len(procs), None
        while left:
            if stop["signal"] is not None:
                _end(procs)
                return 128 + stop["signal"]
            try:
                rank, code = ended.get(timeout=0.1)
            except queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    _end(procs)
                    break
                continue
            left -= 1
            if code != 0:
                failures.append((rank, code))
                print(f"launch: rank {rank} ended with {code}"
                      + ("; ending the others" if deadline is None else ""),
                      file=sys.stderr, flush=True)
                if deadline is None:
                    deadline = time.monotonic() + args.abort_grace
        return 0 if not failures else _exit_code(_cause(failures)[1])
    finally:
        _end(procs)
        for f in logs:
            f.close()
        for s, h in old.items():
            signal.signal(s, h)
