#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernel

Phases, in order; any failure exits non-zero and nothing is caught:

* build   -- compile every CUDA source of the port with nvcc (sm_90a).
* kernel  -- hold the flash-attention forward kernel against its plain
             PyTorch version on the card, fp32, bf16 and fp16, at the GPT-2 small
             path shape and at the edge shapes; time it at the path shape
             beside its bound, its plain version and PyTorch's own
             scaled_dot_product_attention (a yardstick the port never calls).
* forward -- GPT-2 small (full width, seeded random weights): fp32 logits on
             the card (through the kernel) against a CPU twin (plain
             attention); then a timed bf16 forward at B=4, S=1024.
* serve   -- a GPT-2 small fp32 PagedEngine answers 12 requests (more than
             its 8 slots); its greedy tokens must equal a full-recompute
             greedy loop through model(ids); then the same requests on a
             bf16 engine, timed.

The forward and serve phases are the main path: every kernel's launch
count is set to 0 before them and read after them. The last lines are
the kernels' JSON summary, the card's name and power limit from
nvidia-smi, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("build", "kernel", "forward", "serve")
PATH_SHAPE = dict(b=4, s=1024, h=12, d=64)
FP32_TOL = 1e-4
BF16_TOL = 2e-2
FP16_TOL = 5e-3     # one fp16 rounding step at |x| in [4, 8) is 3.9e-3
LOGITS_TOL = 1e-3
TOP2_GAP = 1e-4
# published dense peaks of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3):
    """(median, first quartile, third quartile) of ``iters`` CUDA-event
    timings of ``fn``, in ms, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    q1, median, q3 = statistics.quantiles(times, n=4)
    return median, q1, q3


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ------------------------------------------------------------------ build
def phase_build(state):
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        log_path = path.with_suffix(".log")
        report = log_path.read_text() if log_path.exists() else ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {len(libs)} source(s) in {secs:.2f} s")


# ----------------------------------------------------------------- kernel
def _kernel_case(fa, b, s_q, s_k, h, d, causal, dtype, gen):
    q = randn((b, s_q, h, d), dtype, gen)
    k = randn((b, s_k, h, d), dtype, gen)
    v = randn((b, s_k, h, d), dtype, gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    # LSE only where the row sees at least one key
    rows = torch.arange(s_q, device="cuda")
    seen = rows + (s_k - s_q) >= 0 if causal else rows >= 0
    lse_err = ((lse - ref_lse)[:, :, seen].abs().max().item()
               if bool(seen.any()) else 0.0)
    blind = out[:, ~seen].float().abs().max().item() if bool((~seen).any()) \
        else 0.0
    return err, lse_err, blind


def phase_kernel(state):
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    p = PATH_SHAPE
    cases = [
        ("path", p["b"], p["s"], p["s"], p["h"], p["d"], True),
        ("path non-causal", p["b"], p["s"], p["s"], p["h"], p["d"], False),
        ("s_q=1 vs 1024", 4, 1, 1024, 12, 64, True),
        ("s_q=17 vs 1024", 4, 17, 1024, 12, 64, True),
        ("s_q=100 vs 64 (blind rows)", 2, 100, 64, 12, 64, True),
        ("ragged S=1000", 2, 1000, 1000, 12, 64, True),
        ("d=128", 1, 2048, 2048, 8, 128, True),
    ]
    worst = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL),
                       (torch.float16, FP16_TOL)):
        for name, b, s_q, s_k, h, d, causal in cases:
            err, lse_err, blind = _kernel_case(fa, b, s_q, s_k, h, d, causal,
                                               dtype, gen)
            tag = str(dtype).replace("torch.", "")
            log(f"  kernel {tag:8s} {name:28s} max_abs_err={err:.3e} "
                f"lse_err={lse_err:.3e} blind_rows_max={blind:.1e}")
            if not (err <= tol and lse_err <= tol and blind == 0.0):
                raise AssertionError(
                    f"flash_attention_fwd disagrees with its plain version: "
                    f"{tag} {name}: err {err}, lse_err {lse_err}, "
                    f"blind rows {blind} (tolerance {tol})")
            if name == "path" and dtype == torch.bfloat16:
                worst["max_abs_err"] = err

    # timing at the path shape, bf16, causal (the forward's configuration)
    b, s, h, d = p["b"], p["s"], p["h"], p["d"]
    q, k, v = (randn((b, s, h, d), torch.bfloat16, gen) for _ in range(3))
    kernel_ms, kernel_q1, kernel_q3 = time_ms(
        lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_ms, _, _ = time_ms(
        lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, _, _ = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    elem = q.element_size()
    moved = 4 * b * s * h * d * elem + b * h * s * 4      # q, k, v, out, lse
    pairs = s * (s + 1) // 2                              # causal (q, k) pairs
    flops = 4.0 * b * h * d * pairs
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    row = {"kernel": "flash_attention_fwd", "shape": "B4 S1024 H12 d64 bf16 "
           "causal", "kernel_ms": kernel_ms, "kernel_ms_q1": kernel_q1,
           "kernel_ms_q3": kernel_q3, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
           "library_ms": library_ms, "plain_ms": plain_ms,
           "bytes": moved, "flops": flops}
    log(json.dumps(row))
    state["kernels"] = {"flash_attention_fwd": dict(
        worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=row["bound_by"], library_ms=library_ms)}


# ---------------------------------------------------------------- forward
def phase_forward(state):
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small

    cfg = gpt2_small()
    model = GPTForCausalLM(cfg, device="cuda", seed=0).eval()
    twin = GPTForCausalLM(cfg, device="cpu", seed=1).eval()
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    state["model"] = model
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 256)))
    with torch.inference_mode():
        before = fa.flash_attention_fwd.launches
        card = model(ids.cuda()).float().cpu()
        per_forward = fa.flash_attention_fwd.launches - before
        cpu = twin(ids)
    diff = (card - cpu).abs().max().item()
    log(f"forward: fp32 B=1 S=256 logits card vs CPU twin max_abs_diff="
        f"{diff:.3e} (tolerance {LOGITS_TOL}); kernel launches per forward="
        f"{per_forward}")
    if not torch.isfinite(card).all() or diff > LOGITS_TOL:
        raise AssertionError(f"forward logits disagree: {diff}")
    if per_forward != cfg.num_layers:
        raise AssertionError(f"expected {cfg.num_layers} kernel launches per "
                             f"forward, saw {per_forward}")
    del twin

    bf16 = GPTForCausalLM(cfg, device="cuda", dtype="bfloat16", seed=1).eval()
    bf16.load_state_dict(model.state_dict())
    state["model_bf16"] = bf16
    ids4 = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 1024))).cuda()
    with torch.inference_mode():
        before = fa.flash_attention_fwd.launches
        logits = bf16(ids4)
        torch.cuda.synchronize()
        if fa.flash_attention_fwd.launches - before != cfg.num_layers:
            raise AssertionError("bf16 forward did not launch the kernel "
                                 "once a layer")
        if not torch.isfinite(logits.float()).all():
            raise AssertionError("bf16 forward gave non-finite logits")
        fwd_ms, fwd_q1, fwd_q3 = time_ms(lambda: bf16(ids4), iters=10)
        if state.get("profile"):
            _profile("forward bf16 B4 S1024", lambda: bf16(ids4))
    tokens = 4 * 1024
    log(json.dumps({"forward": "gpt2_small bf16 B4 S1024", "ms": fwd_ms,
                    "ms_q1": fwd_q1, "ms_q3": fwd_q3,
                    "tokens_per_s": tokens / fwd_ms * 1e3}))


# ------------------------------------------------------------------ serve
def _reference_greedy(model, prompt, n_new):
    """Full-recompute greedy loop through model(ids); keeps the top-two
    logit gap of each step."""
    ids = list(prompt)
    toks, gaps = [], []
    with torch.inference_mode():
        for _ in range(n_new):
            logits = model(torch.tensor([ids], device="cuda"))[0, -1].float()
            top = torch.topk(logits, 2).values
            nxt = int(torch.argmax(logits))
            toks.append(nxt)
            gaps.append(float(top[0] - top[1]))
            ids.append(nxt)
    return toks, gaps


def _serve(model, prompts, n_new):
    from paddle_tpu_torch.inference import GPTPagedEngine
    eng = GPTPagedEngine(model, max_batch=8, block_size=16, num_blocks=512,
                         max_blocks_per_seq=64)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    missing = [r for r in rids if r not in out or len(out[r]) != n_new]
    if missing:
        raise AssertionError(f"requests {missing} did not finish")
    return [out[r] for r in rids], wall, eng


def _profile(label, fn):
    """Run ``fn`` under torch.profiler; print the operators by device time
    and one JSON line with the device-busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=20))
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) * 1e-6
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel"))
    log(json.dumps({"profile": label, "wall_s": wall, "device_busy_s": busy,
                    "device_busy_share": busy / wall, "device_ops":
                    len(on_device), "host_kernel_launches": launches}))


def phase_serve(state):
    model = state["model"]
    cfg = model.cfg
    rng = np.random.RandomState(7)
    n_new = 32
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in rng.randint(32, 257, size=12)]
    got, wall, _ = _serve(model, prompts, n_new)
    log(f"serve: fp32 engine answered {len(prompts)} requests "
        f"(prompt lengths {[len(p) for p in prompts]}) in {wall:.2f} s")
    for i, (p, toks) in enumerate(zip(prompts, got)):
        ref, gaps = _reference_greedy(model, p, n_new)
        if toks == ref:
            continue
        j = next(j for j, (a, b) in enumerate(zip(toks, ref)) if a != b)
        if gaps[j] >= TOP2_GAP:
            raise AssertionError(
                f"request {i}: engine token {toks[j]} != reference {ref[j]} "
                f"at step {j} (top-two gap {gaps[j]:.3e})")
        log(f"  request {i}: diverges at step {j} on a near tie (top-two "
            f"gap {gaps[j]:.3e} < {TOP2_GAP}); accepted")
    log("serve: fp32 greedy tokens match the full-recompute loop")

    if state.get("profile"):
        _serve(state["model_bf16"], prompts[:8], 4)      # warm-up
        _profile("serve bf16, 8 requests",
                 lambda: _serve(state["model_bf16"], prompts[:8], n_new))
    got16, wall16, eng16 = _serve(state["model_bf16"], prompts, n_new)
    decode = eng16.phase_seconds["decode"]
    prefill = eng16.phase_seconds["prefill"]
    same = sum(a == b for x, y in zip(got, got16) for a, b in zip(x, y))
    log(json.dumps({
        "serve": "gpt2_small bf16 PagedEngine max_batch=8 block_size=16",
        "requests": len(prompts), "generated_tokens": len(prompts) * n_new,
        "wall_s": wall16, "tokens_per_s": len(prompts) * n_new / wall16,
        "decode_tick_ms_median": statistics.median(decode) * 1e3,
        "decode_ticks": len(decode), "prefill_chunks": len(prefill),
        "prefill_chunk_ms_median": statistics.median(prefill) * 1e3,
        "tokens_equal_to_fp32": same}))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of a "
                        "bf16 engine run")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import paddle_tpu_torch.ops.cuda.flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    state = {"profile": args.profile}
    for phase in PHASES:
        if phase not in phases:
            continue
        if phase == "forward":
            fa.flash_attention_fwd.launches = 0     # the main path starts
        log(f"== {phase}")
        globals()[f"phase_{phase}"](state)
    if phases != list(PHASES):
        return 0
    launches = fa.flash_attention_fwd.launches       # the main path ended
    if launches == 0:
        raise AssertionError("the main path never launched "
                             "flash_attention_fwd")
    k1 = state["kernels"]["flash_attention_fwd"]
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:175",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
