"""Per-op roofline and step-time attribution report (counterpart of the
JAX package's ``tools/perf_report.py``).

Renders the attribution layer's two artifacts as markdown (and JSON):

* a **per-op roofline table**: for every dispatched op, its calls, host
  time, modeled FLOPs/bytes (``observability.perf.costmodel``), achieved
  FLOP/s and bytes/s, arithmetic intensity, the attainable roofline at
  that intensity (min(peak FLOP/s, peak bandwidth x intensity)), the
  share of it achieved, and whether compute or bandwidth bounds the op
  on this card;
* a **step-time attribution**: each step split into compute /
  collective / host / idle (the parts sum to the step), with the whole
  step's modeled MFU and the attributed memory census.

The card's peaks come from ``observability.perf``'s datasheet tables
(``chip_peak_flops``/``chip_peak_bw``), unless the caller passes them.

Modes::

    python -m paddle_tpu_torch.tools.perf_report            # the demo loop
    python -m paddle_tpu_torch.tools.perf_report --steps 8 --hidden 128
    python -m paddle_tpu_torch.tools.perf_report --metrics snap.json
        # render a saved snapshot (PADDLE_TPU_METRICS_DUMP with
        # FLAGS_enable_metrics=1 FLAGS_perf_op_cost=1) instead
    python -m paddle_tpu_torch.tools.perf_report --json r.json --markdown r.md

The demo trains a tiny two-layer attention model eagerly (on the card
unless ``--device cpu``) with ``FLAGS_benchmark`` on (a synchronize after
each op), so the dispatch latency histogram holds each op's time on the
card; its attention is ``F.flash_attention``, K1 forward and K2/K3
backward on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

__all__ = ["build_report", "build_report_from_snapshot",
           "render_markdown", "run_demo", "main"]


# --------------------------------------------------------------------------
# Report assembly
# --------------------------------------------------------------------------
def _op_rows(op_time: Dict[str, dict], op_cost: Dict[str, dict],
             peak_flops: float, peak_bw: float) -> List[dict]:
    """Join measured per-op host time with modeled cost into roofline
    rows. ``op_time[op] = {"calls", "total_s"}``; ``op_cost[op] =
    {"flops", "bytes"}`` (totals across the same window)."""
    rows = []
    ridge = peak_flops / peak_bw if peak_bw else float("inf")
    for op, t in op_time.items():
        c = op_cost.get(op, {})
        flops = float(c.get("flops", 0.0))
        nbytes = float(c.get("bytes", 0.0))
        total_s = float(t.get("total_s", 0.0))
        ai = flops / nbytes if nbytes else 0.0
        # zero-FLOP ops (gathers, reshapes) have no FLOP ceiling — an
        # attainable-GFLOP/s column must show 0, not the BW number
        attain = min(peak_flops, peak_bw * ai) if ai > 0 else 0.0
        ach_f = flops / total_s if total_s > 0 else 0.0
        ach_b = nbytes / total_s if total_s > 0 else 0.0
        rows.append({
            "op": op,
            "calls": int(t.get("calls", 0)),
            "host_s": round(total_s, 6),
            "model_gflops": round(flops / 1e9, 4),
            "model_gbytes": round(nbytes / 1e9, 6),
            "achieved_gflops_per_s": round(ach_f / 1e9, 3),
            "achieved_gbytes_per_s": round(ach_b / 1e9, 4),
            "arithmetic_intensity": round(ai, 3),
            "attainable_gflops_per_s": round(attain / 1e9, 3),
            "pct_of_roofline": round(100.0 * ach_f / attain, 2)
            if attain else 0.0,
            "bound": "compute" if ai >= ridge else "bandwidth",
            "op_mfu": round(ach_f / peak_flops, 4) if peak_flops else 0.0,
        })
    rows.sort(key=lambda r: -r["host_s"])
    return rows


def build_report(op_time: Dict[str, dict], op_cost: Dict[str, dict],
                 attribution: Optional[dict] = None,
                 hbm: Optional[dict] = None,
                 compiled: Optional[list] = None,
                 device_info: Optional[dict] = None,
                 cost_window_steps: Optional[int] = None,
                 peaks: Optional[tuple] = None) -> dict:
    """Assemble the report dict from its measured pieces (the demo run,
    the card check and the tests all come through here). ``peaks``:
    (peak FLOP/s, peak bytes/s), else the current card's datasheet
    entries (the CPU fallbacks without CUDA)."""
    from ..observability import perf

    if device_info is None:
        import torch
        if torch.cuda.is_available():
            device_info = {"device_kind": torch.cuda.get_device_name(),
                           "platform": "gpu"}
        else:
            device_info = {"device_kind": "cpu", "platform": "cpu"}
    if peaks is None:
        peak_flops = perf.chip_peak_flops()
        peak_bw = perf.chip_peak_bw()
    else:
        peak_flops, peak_bw = (float(v) for v in peaks)
    device_info.update({
        "peak_gflops_per_s": round(peak_flops / 1e9, 1),
        "peak_hbm_gbytes_per_s": round(peak_bw / 1e9, 1),
        "ridge_intensity_flops_per_byte": round(peak_flops / peak_bw, 2),
    })
    report = {
        "device": device_info,
        "ops": _op_rows(op_time, op_cost, peak_flops, peak_bw),
    }
    total_flops = sum(float(c.get("flops", 0.0)) for c in op_cost.values())
    if attribution:
        tot = attribution.get("total", attribution)
        report["step_attribution"] = attribution
        n = max(int(tot.get("n_steps", 1)), 1)
        step_s = tot.get("step_s", 0.0) / n
        # the op counters and the attribution may cover different numbers
        # of steps: each is normalized by its own window
        cost_n = max(int(cost_window_steps or n), 1)
        flops_per_step = total_flops / cost_n
        report["whole_step"] = {
            "step_s": round(step_s, 6),
            "modeled_flops_per_step": flops_per_step,
            "mfu": round(flops_per_step / (step_s * peak_flops), 4)
            if step_s > 0 else 0.0,
        }
    if hbm:
        report["hbm"] = {k: int(v) for k, v in hbm.items()}
    if compiled:
        report["compiled_programs"] = compiled
    return report


def _series_tables(snap: dict):
    """(op_time, op_cost, hbm) tables out of a metrics snapshot."""
    def series_of(name):
        m = snap.get(name)
        if not m:
            return {}
        out = {}
        for s in m["series"]:
            key = s["labels"][0] if s["labels"] else ""
            out[key] = s["value"]
        return out

    lat = series_of("paddle_tpu_dispatch_op_latency_seconds")
    flops = series_of("paddle_tpu_perf_op_flops_total")
    nbytes = series_of("paddle_tpu_perf_op_bytes_total")
    op_time = {op: {"calls": v["count"], "total_s": v["sum"]}
               for op, v in lat.items() if isinstance(v, dict)}
    op_cost = {op: {"flops": flops.get(op, 0.0),
                    "bytes": nbytes.get(op, 0.0)}
               for op in set(flops) | set(nbytes)}
    hbm = series_of("paddle_tpu_hbm_live_bytes")
    return op_time, op_cost, hbm


def build_report_from_snapshot(snap: dict,
                               peaks: Optional[tuple] = None) -> dict:
    """Roofline rows from a saved metrics snapshot (it needs the
    ``paddle_tpu_dispatch_op_latency_seconds`` histogram and the
    ``paddle_tpu_perf_op_{flops,bytes}_total`` counters: a run with
    FLAGS_enable_metrics=1 FLAGS_perf_op_cost=1)."""
    op_time, op_cost, hbm = _series_tables(snap)
    return build_report(op_time, op_cost, hbm=hbm or None, peaks=peaks)


# --------------------------------------------------------------------------
# Markdown rendering
# --------------------------------------------------------------------------
def _fmt_row(cells, widths):
    return "| " + " | ".join(str(c).ljust(w)
                             for c, w in zip(cells, widths)) + " |"


def render_markdown(report: dict, top_n: int = 25) -> str:
    d = report["device"]
    lines = ["# paddle_tpu performance attribution", ""]
    lines.append(
        f"device: **{d.get('device_kind')}** — peak "
        f"{d.get('peak_gflops_per_s')} GFLOP/s, "
        f"{d.get('peak_hbm_gbytes_per_s')} GB/s HBM "
        f"(ridge {d.get('ridge_intensity_flops_per_byte')} FLOP/B)")
    lines.append("")
    if "whole_step" in report:
        w = report["whole_step"]
        lines.append(
            f"whole step: {w['step_s'] * 1e3:.3f} ms, modeled "
            f"{w['modeled_flops_per_step'] / 1e9:.2f} GFLOPs → "
            f"**MFU {w['mfu']:.3f}**")
        lines.append("")
    if "step_attribution" in report:
        tot = report["step_attribution"]["total"]
        lines.append("## Step-time attribution")
        lines.append("")
        hdr = ["component", "seconds", "fraction"]
        widths = [12, 10, 8]
        lines.append(_fmt_row(hdr, widths))
        lines.append(_fmt_row(["---"] * 3, widths))
        for k in ("compute", "collective", "host", "idle"):
            lines.append(_fmt_row(
                [k, f"{tot[k + '_s']:.4f}", f"{tot[k + '_frac']:.3f}"],
                widths))
        lines.append(_fmt_row(["step total", f"{tot['step_s']:.4f}",
                               "1.000"], widths))
        lines.append("")
    ops = report.get("ops", [])
    if ops:
        lines.append("## Per-op roofline (by host time)")
        lines.append("")
        hdr = ["op", "calls", "host ms", "GFLOPs", "GFLOP/s", "GB/s",
               "AI", "attainable", "% roof", "bound"]
        widths = [24, 6, 9, 9, 9, 8, 7, 10, 7, 9]
        lines.append(_fmt_row(hdr, widths))
        lines.append(_fmt_row(["---"] * len(hdr), widths))
        for r in ops[:top_n]:
            lines.append(_fmt_row(
                [r["op"], r["calls"], f"{r['host_s'] * 1e3:.2f}",
                 f"{r['model_gflops']:.2f}",
                 f"{r['achieved_gflops_per_s']:.1f}",
                 f"{r['achieved_gbytes_per_s']:.2f}",
                 f"{r['arithmetic_intensity']:.1f}",
                 f"{r['attainable_gflops_per_s']:.1f}",
                 f"{r['pct_of_roofline']:.1f}", r["bound"]], widths))
        lines.append("")
    if "hbm" in report:
        lines.append("## HBM census (attributed live bytes)")
        lines.append("")
        widths = [16, 14]
        lines.append(_fmt_row(["tag", "bytes"], widths))
        lines.append(_fmt_row(["---"] * 2, widths))
        for tag, v in sorted(report["hbm"].items()):
            lines.append(_fmt_row([tag, f"{int(v):,}"], widths))
        lines.append("")
    if report.get("compiled_programs"):
        lines.append("## Captured programs (FlopCounterMode analysis)")
        lines.append("")
        widths = [10, 28, 12, 14, 12]
        lines.append(_fmt_row(["site", "label", "GFLOPs", "bytes acc.",
                               "peak bytes"], widths))
        lines.append(_fmt_row(["---"] * 5, widths))
        for p in report["compiled_programs"][:top_n]:
            lines.append(_fmt_row(
                [p["site"], p["label"][:28],
                 f"{p.get('flops', 0.0) / 1e9:.3f}",
                 f"{int(p.get('bytes_accessed', 0)):,}",
                 f"{int(p.get('peak_bytes', 0)):,}"], widths))
        lines.append("")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Demo workload
# --------------------------------------------------------------------------
def run_demo(steps: int = 4, hidden: int = 64, batch: int = 4,
             seq: int = 32, device: Optional[str] = None) -> dict:
    """Train a tiny attention model eagerly for ``steps`` steps with the
    attribution stack armed, and build the report (on the card unless
    ``device="cpu"``)."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.observability import REGISTRY, perf

    dev = device or "gpu:0"
    paddle.set_flags({"FLAGS_enable_metrics": True,
                      "FLAGS_perf_op_cost": True,
                      "FLAGS_benchmark": True})
    perf.attach_cost_models()
    REGISTRY.reset()
    perf.memory.reset_high_water()
    try:
        with paddle.device_guard(dev):
            paddle.seed(0)

            class _Tiny(nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.emb = nn.Embedding(97, hidden)
                    self.q = nn.Linear(hidden, hidden)
                    self.k = nn.Linear(hidden, hidden)
                    self.v = nn.Linear(hidden, hidden)
                    self.ln = nn.LayerNorm(hidden)
                    self.head = nn.Linear(hidden, 97)

                def forward(self, ids):
                    import paddle_tpu_torch.nn.functional as F

                    x = self.emb(ids)
                    b, s, h = x.shape

                    def split(t):
                        return t.reshape([b, s, 4, h // 4])
                    a, _ = F.flash_attention(split(self.q(x)),
                                             split(self.k(x)),
                                             split(self.v(x)))
                    x = self.ln(x + a.reshape([b, s, h]))
                    return self.head(x)

            model = _Tiny()
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=model.parameters())
            rng = np.random.RandomState(0)
            ids = paddle.to_tensor(
                rng.randint(0, 97, (batch, seq)).astype(np.int64))

            def one_step():
                import paddle_tpu_torch.nn.functional as F

                logits = model(ids)
                loss = F.cross_entropy(logits.reshape([-1, 97]),
                                       ids.reshape([-1]))
                loss.backward()
                opt.step()
                opt.clear_grad()
                perf.update_high_water("train_step")
                return loss

            # the per-op pass: a synchronize after each op
            # (FLAGS_benchmark), so the dispatch latency histogram holds
            # each op's time on the card: the roofline's denominator
            for _ in range(max(steps, 1)):
                one_step()
            op_time, op_cost, _ = _series_tables(REGISTRY.snapshot())

            # the attribution pass: no synchronize per op, so the card's
            # work drains inside the timed_section's wait (compute) and
            # the host spans stay host
            paddle.set_flags({"FLAGS_benchmark": False})
            attribution = perf.step_attribution(one_step, iters=2,
                                                warmup=0, name="train_step")
            hbm = perf.census()
    finally:
        paddle.set_flags({"FLAGS_enable_metrics": False,
                          "FLAGS_perf_op_cost": False,
                          "FLAGS_benchmark": False})
    return build_report(op_time, op_cost, attribution=attribution,
                        hbm=hbm, compiled=perf.compiled_programs(),
                        cost_window_steps=max(steps, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--metrics", help="render a saved metrics snapshot "
                    "instead of running the demo loop")
    ap.add_argument("--json", help="write the report dict here")
    ap.add_argument("--markdown", help="write markdown here "
                    "(default: stdout)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="the demo's device: the card unless 'cpu'")
    args = ap.parse_args(argv)

    if args.metrics:
        try:
            with open(args.metrics) as f:
                snap = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read snapshot {args.metrics!r}: {e}",
                  file=sys.stderr)
            return 1
        report = build_report_from_snapshot(snap)
    else:
        report = run_demo(steps=args.steps, hidden=args.hidden,
                          device=args.device)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    md = render_markdown(report, top_n=args.top)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
    else:
        print(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
