"""Runs ``tests/torch_dist_worker.py`` through the port's launcher, one
process a rank on the CPU (gloo), for the port's multi-process tests."""
import json
import os
import random
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")


def free_port() -> int:
    """A free port below Linux's default ephemeral range (32768-60999): a
    port the OS handed out (bind to 0) can go to another test's or gloo's
    socket before rank 0 binds it, and a rank that connects to a
    stranger's socket aborts."""
    rng = random.Random(os.getpid() * 1000003 + time.time_ns())
    for _ in range(200):
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in [20000, 32000)")


def launch(job, nproc, inputs, outdir, abort_grace=10.0, timeout=240):
    """Write ``inputs`` (name -> array), run ``job`` on ``nproc`` ranks;
    returns the launcher's CompletedProcess (rank logs under
    ``outdir/log``)."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "in.npz")
    np.savez(path, **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(nproc), "--master",
         f"127.0.0.1:{free_port()}", "--log_dir",
         os.path.join(outdir, "log"), "--abort_grace", str(abort_grace),
         WORKER, job, path, str(outdir)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)


def logs(outdir) -> str:
    d = os.path.join(outdir, "log")
    return "\n".join(f"--- {name}\n" + open(os.path.join(d, name)).read()
                     for name in sorted(os.listdir(d)))


def outputs(outdir, tag, nproc):
    return [dict(np.load(os.path.join(outdir, f"{tag}.r{r}.npz")))
            for r in range(nproc)]


def losses(outdir, nproc):
    out = []
    for r in range(nproc):
        with open(os.path.join(outdir, f"train.r{r}.json")) as f:
            out.append(json.load(f))
    return out
