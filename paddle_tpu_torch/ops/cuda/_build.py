"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own into ``paddle_tpu_torch/_build/lib<name>-<hash>.so``;
``csrc/*.cuh`` are headers the sources share. The hash covers the source,
the headers and the flags, so an edited source builds anew and an
unchanged one is loaded as it is. Nothing is built when a
module is imported: the first call that needs a library builds it, and
``build_all`` builds every source at once, one ``nvcc`` each, all started
together.

This is a separate path from ``torch.utils.cpp_extension.load``: a
source that includes no PyTorch header builds in seconds where one that
does takes minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each nvcc of this process took, from its start to its end
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by the source, the shared
    headers ``csrc/*.cuh`` and the flags)."""
    digest = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    stdout, stderr = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{stdout}{stderr}")
    # the ptxas report (registers, shared memory, spills) rides beside
    # the library for whoever wants to read it
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(tmp, out)


def sources() -> List[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Build the named sources (default: all), in parallel; return their
    library paths. Raises with nvcc's output if any build fails."""
    names = list(names) or sources()
    with _lock:
        jobs = {n: _start(n) for n in names}
        errors = []

        def finish(n, job):
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        # one waiter a build, so each one's time ends when its nvcc does
        waiters = [threading.Thread(target=finish, args=(n, job))
                   for n, job in jobs.items() if job is not None]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
