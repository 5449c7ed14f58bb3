"""``python -m paddle_tpu_torch.observability``: print the metrics
snapshot (counterpart of ``paddle_tpu/observability/__main__.py``).

    python -m paddle_tpu_torch.observability              # this process
    python -m paddle_tpu_torch.observability --format json
    python -m paddle_tpu_torch.observability --input /tmp/metrics.json
    python -m paddle_tpu_torch.observability --merge /tmp/metrics.json

Without ``--input`` the snapshot is this process's registry (mostly the
callback gauges); ``--input`` renders a snapshot that
``PADDLE_TPU_METRICS_DUMP=/path`` wrote from an instrumented run;
``--merge BASE`` folds BASE and every per-process sibling (``BASE.rankN``
from distributed ranks, ``BASE.pidN`` from loader workers) into one
aggregate whose series carry a leading ``rank`` label. The exit status is
0 unless the input files cannot be read.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.observability",
        description="print the framework metrics snapshot")
    ap.add_argument("--format", choices=("prom", "json"), default="prom",
                    help="output format (default: Prometheus text)")
    ap.add_argument("--input", help="render a saved JSON snapshot file "
                    "instead of this process's registry")
    ap.add_argument("--merge", metavar="BASE",
                    help="fold BASE + BASE.rankN/.pidN snapshot files "
                    "into one rank-labeled aggregate and render it")
    ap.add_argument("--output", help="write the rendered output to a "
                    "file instead of stdout")
    args = ap.parse_args(argv)

    if args.merge:
        from .metrics import merge_snapshot_files
        try:
            snap = merge_snapshot_files(args.merge)
        except (OSError, ValueError) as e:
            print(f"cannot merge snapshots at {args.merge!r}: {e}",
                  file=sys.stderr)
            return 1
    elif args.input:
        try:
            with open(args.input) as f:
                snap = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read snapshot {args.input!r}: {e}",
                  file=sys.stderr)
            return 1
    else:
        from . import REGISTRY
        try:
            # the attributed memory gauges are census-time: refresh first
            from .perf import memory as _perf_memory
            _perf_memory.refresh_metrics()
        except Exception:
            pass
        snap = REGISTRY.snapshot()

    if args.format == "json":
        text = json.dumps(snap, indent=1, sort_keys=True) + "\n"
    else:
        from .metrics import render_prometheus
        text = render_prometheus(snap)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
