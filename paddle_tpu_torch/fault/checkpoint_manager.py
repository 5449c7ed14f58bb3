"""CheckpointManager: rotation, manifest, verified resume (counterpart
of ``paddle_tpu/fault/checkpoint_manager.py``, the JAX package's code;
a directory one package's manager writes, the other's restores).

The preemption-tolerant training pattern (PaLM's resume-from-latest,
Megatron-LM's distributed checkpointing): saves land atomically via
:mod:`..framework.io`, a JSON manifest records every COMPLETED save (it
is written only after the checkpoint itself is published, so a crash
between the two leaves a valid orphan checkpoint that restore still
finds by directory scan), rotation keeps the newest ``keep_n``, and
``restore()`` walks newest→oldest, falling back PAST a corrupt or
partial checkpoint to the last verifiable one instead of dying on the
damage. The fallback depth is exported as a metric so a fleet quietly
burning its newest checkpoints shows up on a dashboard, not in a
post-mortem.
"""
from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

from ..framework import io as _fio
from ..observability import goodput as _goodput
from ..observability import metrics as _metrics
from .retry import RetryPolicy, retry

__all__ = ["CheckpointManager", "auto_resume", "capture_train_state",
           "restore_train_state"]

_MANIFEST = "manifest.json"

_m_fallback_depth = _metrics.gauge(
    "paddle_tpu_resume_fallback_depth",
    "How many newest checkpoints the last restore() had to skip "
    "(0 = newest loaded clean).")
_m_fallback_total = _metrics.counter(
    "paddle_tpu_resume_fallback_total",
    "restore() calls that fell back past at least one bad checkpoint.")
_m_rotated = _metrics.counter(
    "paddle_tpu_ckpt_rotated_total", "Checkpoints deleted by rotation.")


class CheckpointManager:
    """Directory of rotated, atomically-published checkpoints.

    ``save(state, step=...)`` writes ``<prefix>-<step>.pdckpt`` (atomic +
    checksummed, retried on transient OSError), appends the manifest, and
    prunes beyond ``keep_n``. ``restore()`` returns ``(state, meta)``
    from the newest checkpoint that passes verification, skipping any
    that don't.
    """

    def __init__(self, directory: str, keep_n: int = 3,
                 prefix: str = "ckpt",
                 retry_policy: Optional[RetryPolicy] = None,
                 protocol: int = 4):
        if keep_n < 1:
            raise ValueError(f"keep_n must be >= 1, got {keep_n}")
        self.directory = str(directory)
        self.keep_n = int(keep_n)
        self.prefix = prefix
        self.protocol = protocol
        self.retry_policy = retry_policy or RetryPolicy()
        #: fallback depth of the most recent restore(); None before any
        self.last_fallback_depth: Optional[int] = None
        self._pat = re.compile(
            re.escape(prefix) + r"-(\d+)\.pdckpt$")
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------ listing
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, _MANIFEST)

    def manifest(self) -> List[dict]:
        """Entries of completed saves, oldest→newest; tolerant of a
        missing or torn manifest (restore never depends on it)."""
        try:
            with open(self._manifest_path()) as f:
                entries = json.load(f)
            return entries if isinstance(entries, list) else []
        except (OSError, ValueError):
            return []

    def checkpoints(self) -> List[str]:
        """Checkpoint paths newest→oldest, by directory scan (the
        authority on what exists — a save that completed but crashed
        before its manifest append is still found here)."""
        found = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            m = self._pat.match(name)
            if m:
                found.append((int(m.group(1)), name))
        return [os.path.join(self.directory, name)
                for _, name in sorted(found, reverse=True)]

    def latest(self) -> Optional[str]:
        ckpts = self.checkpoints()
        return ckpts[0] if ckpts else None

    def steps(self) -> List[int]:
        """Completed-save steps newest→oldest, by the same directory scan
        as :meth:`checkpoints` — the per-rank manifest the consensus
        rewind exchanges across the fleet."""
        out = []
        for path in self.checkpoints():
            m = self._pat.match(os.path.basename(path))
            if m:
                out.append(int(m.group(1)))
        return out

    # --------------------------------------------------------------- save
    def save(self, state: Any, step: int, epoch: Optional[int] = None,
             meta: Optional[dict] = None) -> str:
        """Atomically publish ``state`` as the checkpoint for ``step``,
        record it in the manifest, then rotate."""
        meta = dict(meta or {})
        meta.setdefault("step", int(step))
        if epoch is not None:
            meta.setdefault("epoch", int(epoch))
        fname = f"{self.prefix}-{int(step):010d}.pdckpt"
        path = os.path.join(self.directory, fname)
        payload = {"state": state, "meta": meta}
        with _goodput.bill("checkpoint"):
            retry(lambda: _fio.save(payload, path, protocol=self.protocol),
                  policy=self.retry_policy, site="ckpt.save")
        entries = [e for e in self.manifest() if e.get("file") != fname]
        entries.append({"file": fname, "step": int(step), "epoch": epoch,
                        "bytes": os.path.getsize(path), "meta": meta})
        entries.sort(key=lambda e: e.get("step", 0))
        self._write_manifest(entries)
        self._rotate()
        return path

    def _write_manifest(self, entries: List[dict]):
        with _fio.atomic_file(self._manifest_path()) as tmp:
            with open(tmp, "w") as f:
                json.dump(entries, f, indent=1)
                f.flush()
                os.fsync(f.fileno())

    def _rotate(self):
        doomed = self.checkpoints()[self.keep_n:]
        for path in doomed:
            try:
                os.unlink(path)
                _m_rotated.inc()
            except OSError:
                pass
        if doomed:
            gone = {os.path.basename(p) for p in doomed}
            self._write_manifest(
                [e for e in self.manifest() if e.get("file") not in gone])

    # ------------------------------------------------------------ restore
    def restore(self, verify: bool = True, max_step: Optional[int] = None
                ) -> Optional[Tuple[Any, Dict[str, Any]]]:
        """``(state, meta)`` from the newest checkpoint that loads clean,
        falling back past corrupt/partial ones (each skip warns and
        counts); None when nothing in the directory is loadable.

        ``max_step`` bounds the candidates to steps <= it — the
        consensus-rewind path restores the newest step completed on
        EVERY rank, so a rank that saved further ahead must skip its
        extra checkpoints (not a fallback: they aren't damaged, they
        are unilateral)."""
        cands = self.checkpoints()
        if max_step is not None:
            kept = []
            for path in cands:
                m = self._pat.match(os.path.basename(path))
                if m and int(m.group(1)) <= int(max_step):
                    kept.append(path)
            cands = kept
        for depth, path in enumerate(cands):
            try:
                with _goodput.bill("checkpoint"):
                    payload = _fio.load(path, verify=verify)
            except (_fio.CheckpointCorruptError, OSError, EOFError,
                    ValueError, KeyError) as e:
                warnings.warn(
                    f"CheckpointManager: skipping unloadable checkpoint "
                    f"{path!r}: {e}")
                continue
            if not isinstance(payload, dict) or "state" not in payload:
                warnings.warn(
                    f"CheckpointManager: {path!r} is not a manager "
                    f"checkpoint (no 'state' key); skipping")
                continue
            self.last_fallback_depth = depth
            _m_fallback_depth.set(depth)
            if depth:
                _m_fallback_total.inc()
            return payload["state"], dict(payload.get("meta") or {})
        self.last_fallback_depth = None
        return None


# ------------------------------------------------------- train-state glue
def capture_train_state(network=None, optimizer=None, scaler=None) -> dict:
    """Standard train-state payload: model + optimizer + GradScaler
    state_dicts (whichever are provided)."""
    state: Dict[str, Any] = {}
    if network is not None:
        state["model"] = network.state_dict()
    if optimizer is not None and hasattr(optimizer, "state_dict"):
        state["optimizer"] = optimizer.state_dict()
    if scaler is not None and hasattr(scaler, "state_dict"):
        state["scaler"] = scaler.state_dict()
    return state


def restore_train_state(state: dict, network=None, optimizer=None,
                        scaler=None):
    """Inverse of :func:`capture_train_state` (missing pieces are
    skipped, so a checkpoint saved without a scaler restores into a run
    that has one). Values are copied into the live parameters and the
    optimizer's own tensors; nothing keeps a reference to ``state``."""
    if network is not None and state.get("model") is not None:
        network.set_state_dict(state["model"])
    if optimizer is not None and state.get("optimizer") is not None and \
            hasattr(optimizer, "set_state_dict"):
        optimizer.set_state_dict(state["optimizer"])
    if scaler is not None and state.get("scaler") is not None and \
            hasattr(scaler, "load_state_dict"):
        scaler.load_state_dict(state["scaler"])


def auto_resume(manager: CheckpointManager, network=None, optimizer=None,
                scaler=None, verify: bool = True,
                max_step: Optional[int] = None) -> Optional[dict]:
    """Restore the newest verifiable train state into the given pieces;
    returns its meta (``step``/``epoch``/...) for the training loop to
    fast-forward its counters, or None when there is nothing to resume
    from.  ``max_step`` bounds the restore to the cross-rank consensus
    step (the JAX package's ``fault.supervisor.consensus_resume`` computes
    and passes it; the port's is still to come)."""
    out = manager.restore(verify=verify, max_step=max_step)
    if out is None:
        return None
    state, meta = out
    with _goodput.bill("checkpoint"):
        restore_train_state(state, network=network, optimizer=optimizer,
                            scaler=scaler)
    if meta.get("step") is not None:
        # the steps between this checkpoint and where the crashed run
        # had progressed will be recomputed — the ledger bills them as
        # restart-rewind badput (prior progress from its own account,
        # or the previous process's PADDLE_TPU_GOODPUT exit dump)
        _goodput.ledger().note_resume(int(meta["step"]))
    return meta
