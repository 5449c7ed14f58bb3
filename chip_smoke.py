#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernel

Phases, in order; any failure exits non-zero and nothing is caught:

* build   -- compile every CUDA source of the port with nvcc (sm_90a), one
             nvcc each, all started together; print the ptxas report.
* kernel  -- hold the flash-attention forward kernel (K1) and the backward
             kernels (K2 dQ, K3 dK/dV) against their plain PyTorch versions
             on the card, fp32, bf16 and fp16, at the path shapes and at the
             edge shapes, and K2/K3 against themselves (two calls bitwise
             equal); time each at its path shapes beside its bound, its
             plain version and PyTorch's own flash attention (a yardstick the
             port never calls), and its host time a call.
* fused_kernel -- the same for the fusion pass's kernels: K4 residual + norm,
             K5 bias + activation, K6 norm + matmul + activation, K7 matmul +
             rope, at the path shapes of the fusion phase and at edge shapes
             (ragged rows and columns, widths not multiples of 128, K = 8,
             head dims 16 to 128, rope offsets up to 4000, every activation,
             both norms, with and without bias), K7 against itself (two
             calls bitwise equal); in bf16/fp16 K6's row pass and its
             product are held apart (the rows against the plain rows:
             ROW_NEIGHBOURS, ROW_FP32_ABS; the product against the plain
             product of those rows); each timed beside its bound, its plain
             version, a PyTorch yardstick and its host time a call.
* forward -- GPT-2 small (full width, seeded random weights): fp32 logits on
             the card (through the kernel) against a CPU twin (plain
             attention); then a timed bf16 forward at B=4, S=1024.
* serve   -- a GPT-2 small fp32 PagedEngine answers 12 requests (more than
             its 8 slots); its greedy tokens must equal a full-recompute
             greedy loop through model(ids); then the same requests on a
             bf16 engine, timed.
* serve_llama -- bench.py's serving rung (_bench_serving): LLaMA with
             vocab 32000, hidden 1024, intermediate 2816, 16 layers, 16
             heads of 64, seeded random weights, LlamaPagedEngine at
             bench.py's geometry (8 slots, blocks of 32), its prompts
             (24 lengths in [32, 192) from RandomState(7), tokens from
             RandomState(11)). In fp32, on 8 of them, 32 new tokens each:
             greedy tokens against a full-recompute loop through
             model(ids) (K1 at d=64); int8 KV pages against a loop whose
             K/V are rounded as the pages round them; n-gram speculation
             (k=4, prompts repeated three times) and a prefill budget of
             32 tokens against plain decode, the budget deferring chunks
             while a running request gains a token every tick (all up to
             near ties, TOP2_GAP); sampling (temperature 0.8, top_p 0.9)
             equal in two runs under one seed and under eviction, and
             different under another seed. Then bf16, timed: the whole
             burst, 96 new tokens each, plain, int8 and speculative, one
             JSON line each (tokens/s, median decode tick and prefill
             chunk ms, ticks, agreement with plain, the card).
* serve_tier -- the serving tier's front end at bench.py's resilience and
             router rungs (_bench_serving_resilience, _bench_serving_router,
             _bench_serving_reqtrace): serve_llama's LLaMA without flash
             attention, 8 slots, blocks of 32. In fp32: 8 of serve_llama's
             prompts, 16 new tokens each, through a Router of 2 replicas
             and through a TokenStream, against a plain engine (up to near
             ties, TOP2_GAP); every request timeline complete (validate),
             every router timeline stitched with its replica legs; then the
             reqtrace rung: 150 pairs of decode ticks with FLAGS_reqtrace
             off and on, the order alternating (the ratio, with no limit).
             In bf16: the crash drill (serving.crash_at_tick fails exactly
             the in-flight requests with the injected fault, fresh pages,
             DEGRADED; the queued ones finish and 4 new requests get a
             fresh engine's tokens), the stall drill (serving.tick_stall of
             1.5 s past a 0.5 s watchdog: DEGRADED, recover() -> READY) and
             drain() (STOPPED, every KV block free); the resilience rung
             (48 requests of 32-160 prompt tokens, 64 new tokens each,
             max_queue 192, high-water 32, warmup(80, 64), the capacity
             probe, then 0.5x/1x/2x of its rate under deadlines sized from
             it) and the router rung (its request count cut from
             bench.py's 48 to 32: R=1 and R=2 at saturating arrivals, 64
             requests; then R=2 at 0.5x/1x/2x and a burst of 128, the
             replicas with bounded queues and no high-water mark). One JSON
             line a load point (goodput, p50/p99 TTFT and inter-token
             latency, outcomes, device_attribution: host and card time
             inside the programs, the router's breakdown, the card). Every
             run: each submission terminal, no FAILED outcome, no tick
             failure, no KV block leaked; no shed inside a replica.
* train   -- GPT-2 small fp32 on the card against a CPU twin: 3 AdamW steps
             (warm-up/cosine schedule, global-norm clipping) with per-step
             losses equal to 1e-4; then GPT-2 345M with bf16 weights and
             fp32 masters, AdamW with bench.py's hyperparameters, B=8,
             S=1024, 10 steps on two seeded batches in turn, timed
             (tokens/s and MFU), with a finite loss that falls on the
             repeated batch. Every step must launch K1 once
             a layer in the forward and K2 and K3 once a layer in the
             backward.
* fusion  -- ``to_static`` with FLAGS_enable_fusion: a small GPT-2 and a
             small LLaMA (GQA) in fp32, fused on the card against a fused CPU
             twin (the kernels' plain versions); then LLaMA-770M (bf16, B=4,
             S=2048) and GPT-2 345M (bf16, B=8, S=1024) train with AdamW, the
             fused and the unfused step in turns on one model: step-1 losses
             agree, the loss falls on a repeated batch, and every step
             launches what the pass predicts (LLaMA: K1 24, K4 48, K7 48 in
             the forward; GPT-2: K1 24, K4 48, K6 25; K2 and K3 24 each in the
             backward); then the bias_act program gelu(x W + b), which
             launches K5 once a call.
* rungs   -- bench.py's training rungs at their own settings: bf16 resident
             weights, fp32 masters, bench.py's AdamW, amp O1 bf16
             auto_cast, two seeded batches in turn. GPT-2 345M B=8 S=1024
             with the fused chunked loss, 10 steps (its peak below one
             step's with the plain loss); LLaMA-770M B=4 S=2048 with block
             recompute and the fused loss, 8 steps through to_static with
             FLAGS_enable_fusion and 8 eager in blocks of 4 (step-1 losses
             agree; its peak below one step's without recompute; K1 twice
             a layer a step, K4/K7 in the replay too); LLaMA-1.3B B=2
             S=2048 with recompute, the fused loss and int8 Adam moments,
             4 steps (the moments at most 0.27 of fp32's bytes); GPT-2
             345M fp16 O2 (decorate, GradScaler from 2^16), 10 steps, then
             a step with an inf planted in a gradient: skipped, the scale
             halved, weights, masters and moments bitwise unchanged. One
             JSON line a rung: step ms (median, quartiles), the split by
             CUDA events, tokens/s, MFU, peak memory beside the card's name
             and power limit, the optimizer state's bytes, the losses, the
             launches and the switches.

The forward, serve, serve_llama, serve_tier, train, fusion and rungs
phases are the main path (serve_tier launches no kernel: the tier is host
code over the engine, and its LLaMA runs without flash attention, as
bench.py's rungs do): every kernel's launch count is set to 0 just before
each of them and read just after it. The last lines are the kernels' JSON summary
(all seven, with their launches over the main path), the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}.
``--profile`` adds a torch.profiler breakdown of a bf16 forward, a GPT-2
and a LLaMA engine run, one training step, a fused and an unfused step of
each fusion path, and one step of each rung.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("build", "kernel", "fused_kernel", "forward", "serve",
          "serve_llama", "serve_tier", "train", "fusion", "rungs")
MAIN_PATH = ("forward", "serve", "serve_llama", "serve_tier", "train",
             "fusion", "rungs")
PATH_SHAPE = dict(b=4, s=1024, h=12, d=64)      # GPT-2 small serving
TRAIN_SHAPE = dict(b=8, s=1024, h=16, d=64)     # GPT-2 345M training
LLAMA_ATTN_SHAPE = dict(b=4, s=2048, h=12, d=128)   # LLaMA-770M fusion path
FP32_TOL = 1e-4
BF16_TOL = 2e-2
FP16_TOL = 5e-3     # one fp16 rounding step at |x| in [4, 8) is 3.9e-3
LOGITS_TOL = 1e-3
TOP2_GAP = 1e-4
# backward kernels against their fp32 plain version: fp32 max abs error;
# bf16/fp16 norm-wise relative error (P and dS are rounded to the input
# type before their products, as the TPU kernels round them)
BWD_LIMITS = {torch.float32: 2e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}
LOSS_TOL = 1e-4         # fp32 card vs CPU per-step training loss
# bench.py's AdamW (the JAX package's GPT-2 345M training rung)
ADAMW = dict(beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=0.1)
LR = 2.5e-4
KERNEL_REPS = 10        # launches back to back in one kernel timing
QUEUE_CYCLES = 10_000_000   # a sleep kernel of about 5 ms at the H100's clock
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention_fwd": ("flash_attention_fwd.cu", "flash_attention.py:175"),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu", "flash_attention.py:228"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", "flash_attention.py:273"),
    "fused_residual_norm": ("fused_residual_norm.cu", "fused_ops.py:92"),
    "fused_bias_act": ("fused_bias_act.cu", "fused_ops.py:152"),
    "fused_matmul": ("fused_matmul.cu", "fused_ops.py:180"),
    "fused_matmul_rope": ("fused_matmul.cu", "fused_ops.py:244"),
}
# K4-K7 against their plain versions: fp32 max abs error (unit-normal
# inputs, weights scaled by 1/sqrt(K)); bf16/fp16 one rounding of the output,
# |got - ref| <= REL * |ref| + FUSED_ABS, as both sides round one fp32 value
# that differs only in the order of its sums
FUSED_FP32_TOL = 1e-4
FUSED_REL = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}
FUSED_ABS = 1e-3
# K6's bf16/fp16 row pass against its plain version (fp32 statistics summed
# in another order): each normalized value equal, the neighbour in x's type,
# or within ROW_FP32_ABS of it, where the norm bias cancels the scaled row
# near 0 and x's type is finer there than the terms' fp32 error (two fp32
# units at 4, the rows' largest scale); values not equal at most
# ROW_NEIGHBOURS of all, held where that share allows 100 values or more
ROW_NEIGHBOURS = 1e-4
ROW_FP32_ABS = 2 ** -20
# fused against unfused bf16 step-1 loss (about 0.2% of ln(vocab)): K4
# normalizes the fp32 sum where the unfused chain normalizes the rounded
# sum, and K6/K7 round once where the unfused chain rounds after the
# product and again after the bias, activation or rotation
FUSED_LOSS_TOL = 2e-2
LLAMA_770M = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                  num_layers=24, num_heads=12, max_seq_len=2048)   # bench.py:356
LLAMA_SHAPE = dict(b=4, s=2048)
# published dense peaks of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12     # CUDA cores, for the elementwise kernels


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 1,
            queued: bool = False):
    """(median, first quartile, third quartile) of ``iters`` CUDA-event
    timings of ``fn``, in ms, after warm-up. Each timing spans ``reps``
    calls back to back and is divided by ``reps``: a kernel is timed with
    the card kept busy, as the training step keeps it, not after an idle
    gap of a synchronize. With ``queued`` (the kernel timings) each timing
    starts behind a sleep kernel long enough for the host to queue all
    ``reps`` calls, so it reads the card's time and not the host's rate
    of launches; without it, the time a caller waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    q1, median, q3 = statistics.quantiles(times, n=4)
    return median, q1, q3


def host_ms(fn, calls: int = 50) -> float:
    """Host time of one call of ``fn`` in ms (``calls`` calls enqueued with
    no synchronize in between): where it is longer than the kernel, launches
    back to back leave the card idle between them and ``time_ms`` reads the
    host's rate."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ------------------------------------------------------------------ build
def _ptxas_summary(report):
    """(kernel, "N registers, spills") for each entry function of a
    ``nvcc -Xptxas -v`` report, named like ``dq_wgmma<bf16, 64>``, and
    ("warning", line) for each ptxas warning that ``setmaxnreg`` was
    ignored (C7508) or that wgmma was serialized ("Potential Performance
    Loss")."""
    out, kernel = [], None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if ("C7508" in line or "setmaxnreg ignored" in line
                or "Performance Loss" in line):
            out.append(("warning", line.strip()))
        elif found:
            mangled = found.group(1)
            base = re.search(r"(flash_fwd|dkv|dq|gemm|gemm_rope)_(wgmma|f32)"
                             r"|norm_rows|residual_norm|bias_act", mangled)
            dtype = ("fp16" if "__half" in mangled else
                     "bf16" if "bfloat16" in mangled else "fp32")
            dim = re.search(r"Li(\d+)E", mangled)
            kernel = (f"{base.group(0) if base else mangled}<{dtype}, "
                      f"{dim.group(1) if dim else '?'}>")
        elif "spill" in line and kernel:
            spills = line.strip()
        elif "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((kernel, f"{regs.group(1) if regs else '?'} "
                        f"registers; {spills}"))
            kernel = None
    return out


def phase_build(state):
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        if name in _build.build_seconds:
            log(f"  nvcc {name}: {_build.build_seconds[name]:.2f} s")
        log_path = path.with_suffix(".log")
        report = log_path.read_text() if log_path.exists() else ""
        for kernel, usage in _ptxas_summary(report):
            log(f"  ptxas {name} {kernel}: {usage}")
    log(f"build: {len(libs)} source(s) in {secs:.2f} s")


# ----------------------------------------------------------------- kernel
def _qkv(b, s_q, s_k, h, d, dtype, gen, strided=False):
    """Unit-normal q (B, Sq, H, d), k and v (B, Sk, H, d); ``strided``
    makes them views of one qkv projection, as the model hands them over
    (then Sq == Sk)."""
    if strided:
        qkv = randn((b, s_q, 3 * h * d), dtype, gen)
        return tuple(x.view(b, s_q, h, d) for x in qkv.split(h * d, dim=-1))
    return (randn((b, s_q, h, d), dtype, gen),
            randn((b, s_k, h, d), dtype, gen),
            randn((b, s_k, h, d), dtype, gen))


def _kernel_case(fa, b, s_q, s_k, h, d, causal, strided, dtype, gen):
    q, k, v = _qkv(b, s_q, s_k, h, d, dtype, gen, strided)
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
    serve, train, llama = ((s["b"], s["s"], s["s"], s["h"], s["d"])
                           for s in (PATH_SHAPE, TRAIN_SHAPE, LLAMA_ATTN_SHAPE))
    # (name, b, s_q, s_k, h, d, causal, strided): the three path shapes as
    # the model hands them over (views of the qkv projection) and as
    # separate tensors, then the edges
    cases = [
        ("path", *serve, True, False),
        ("path non-causal", *serve, False, False),
        ("path strided qkv views", *serve, True, True),
        ("train path", *train, True, False),
        ("train strided qkv views", *train, True, True),
        ("llama path", *llama, True, False),
        ("s_q=1 vs 1024", 4, 1, 1024, 12, 64, True, False),
        ("s_q=17 vs 1024", 4, 17, 1024, 12, 64, True, False),
        ("s_q=100 vs 64 (blind rows)", 2, 100, 64, 12, 64, True, False),
        ("s_q=300 vs 64 (blind tiles)", 2, 300, 64, 12, 64, True, False),
        ("ragged S=1000", 2, 1000, 1000, 12, 64, True, False),
        ("ragged S=129", 2, 129, 129, 12, 64, True, False),
        ("ragged S=65", 2, 65, 65, 12, 64, True, False),
        ("ragged S=129 non-causal", 2, 129, 129, 12, 64, False, False),
        ("d=128", 1, 2048, 2048, 8, 128, True, False),
        ("d=128 s_q=17 vs 1024", 2, 17, 1024, 4, 128, True, False),
        ("d=128 ragged S=1000 non-causal", 2, 1000, 1000, 4, 128, False,
         False),
        ("d=128 strided qkv views", 2, 333, 333, 4, 128, True, True),
    ]
    worst = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL),
                       (torch.float16, FP16_TOL)):
        for name, b, s_q, s_k, h, d, causal, strided in cases:
            err, lse_err, blind = _kernel_case(fa, b, s_q, s_k, h, d, causal,
                                               strided, dtype, gen)
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

    # the kernels line carries the serving shape, where slice 1 timed K1
    state.setdefault("kernels", {})["flash_attention_fwd"] = dict(
        worst, **_time_fwd(fa, gen, PATH_SHAPE))
    _time_fwd(fa, gen, TRAIN_SHAPE)
    _time_fwd(fa, gen, LLAMA_ATTN_SHAPE)
    _kernel_bwd(fa, gen, state)


def _bound(moved, flops, peak=BF16_FLOP_PER_S):
    """(bound ms, what bounds it) from bytes moved and FLOPs done at the
    ``peak`` rate of their type."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / peak * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def _visible_pairs(s_q, s_k, causal):
    """(query, key) pairs a head computes: all, or the bottom-right causal
    triangle (query i sees keys <= i + s_k - s_q)."""
    if not causal:
        return s_q * s_k
    return sum(max(0, min(s_k, i + s_k - s_q + 1)) for i in range(s_q))


def _library_attention(q, k, v, causal):
    """PyTorch's own flash attention on BHSD copies of q/k/v (a yardstick
    the port never calls)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
    return (qt, kt, vt), out


def _time_fwd(fa, gen, shape):
    """K1 at one path shape (bf16, causal): its time beside its bound, its
    plain version and PyTorch's SDPA; logs the row and returns the
    kernels-line fields."""
    b, s, h, d = shape["b"], shape["s"], shape["h"], shape["d"]
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, gen)
    def run():
        return fa.flash_attention_fwd(q, k, v, causal=True)
    ms, q1, q3 = time_ms(run, reps=KERNEL_REPS, queued=True)
    host = host_ms(run)
    plain_ms, _, _ = time_ms(
        lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True), iters=5,
        queued=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, _, _ = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=KERNEL_REPS, queued=True)
    moved = 4 * b * s * h * d * q.element_size() + b * h * s * 4  # +lse
    flops = 4.0 * b * h * d * _visible_pairs(s, s, True)
    bound_ms, bound_by = _bound(moved, flops)
    label = f"B{b} S{s} H{h} d{d} bf16 causal"
    log(json.dumps({"kernel": "flash_attention_fwd", "shape": label,
                    "kernel_ms": ms, "kernel_ms_q1": q1, "kernel_ms_q3": q3,
                    "host_ms_a_call": host, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, "plain_ms": plain_ms,
                    "bytes": moved, "flops": flops}))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, shape=label)


def _bwd_errors(got, ref):
    """(max abs error, norm-wise relative error) in fp32."""
    diff = got.float() - ref.float()
    rel = diff.norm() / ref.float().norm().clamp_min(1e-30)
    return diff.abs().max().item(), rel.item()


def _bwd_case(fa, q, k, v, do, causal):
    """K2 and K3 against the plain backward on one input; returns the
    errors of dq, dk, dv and the largest |dq| on rows that see no key."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.flash_attention_bwd_delta(out, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    errs = [_bwd_errors(g, r) for g, r in zip((dq, dk, dv), ref)]
    s_q, s_k = q.shape[1], k.shape[1]
    rows = torch.arange(s_q, device="cuda")
    blind = rows + (s_k - s_q) < 0 if causal else rows < 0
    blind_max = dq[:, blind].float().abs().max().item() \
        if bool(blind.any()) else 0.0
    return errs, blind_max


def _bwd_inputs(b, s_q, s_k, h, d, dtype, gen, strided=False):
    q, k, v = _qkv(b, s_q, s_k, h, d, dtype, gen, strided)
    # with strided views, dO is a strided view too
    do = (randn((b, s_q, h, 2 * d), dtype, gen)[..., :d] if strided
          else randn((b, s_q, h, d), dtype, gen))
    return q, k, v, do


def _kernel_bwd(fa, gen, state):
    t = TRAIN_SHAPE
    train = (t["b"], t["s"], t["s"], t["h"], t["d"])
    llama = tuple(LLAMA_ATTN_SHAPE[x] for x in ("b", "s", "s", "h", "d"))
    cases = [
        ("path", *train, True, False),
        ("path non-causal", *train, False, False),
        ("llama path", *llama, True, False),
        ("s_q=17 vs 1024", 4, 17, 1024, 16, 64, True, False),
        ("s_q=100 vs 64 (blind rows)", 2, 100, 64, 16, 64, True, False),
        ("s_q=300 vs 70 d=128 (blind rows)", 2, 300, 70, 4, 128, True,
         False),
        ("ragged S=1000", 2, 1000, 1000, 16, 64, True, False),
        ("ragged S=257 d=128 non-causal", 2, 257, 257, 4, 128, False,
         False),
        ("d=128", 1, 2048, 2048, 8, 128, True, False),
        ("strided qkv views", *train, True, True),
        ("d=128 strided qkv views", 2, 333, 333, 4, 128, True, True),
    ]
    worst = {}
    for dtype, limit in BWD_LIMITS.items():
        tag = str(dtype).replace("torch.", "")
        for name, b, s_q, s_k, h, d, causal, strided in cases:
            q, k, v, do = _bwd_inputs(b, s_q, s_k, h, d, dtype, gen, strided)
            errs, blind = _bwd_case(fa, q, k, v, do, causal)
            # fp32 is held to its max abs error, bf16/fp16 to the
            # norm-wise relative error
            held = [e[0] if dtype == torch.float32 else e[1] for e in errs]
            log(f"  bwd {tag:8s} {name:33s} " + " ".join(
                f"{g}: abs={a:.2e} rel={r:.2e}"
                for g, (a, r) in zip(("dq", "dk", "dv"), errs))
                + f" blind_dq_max={blind:.1e}")
            if not (max(held) <= limit and blind == 0.0):
                raise AssertionError(
                    f"backward kernels disagree with their plain version: "
                    f"{tag} {name}: {held} (limit {limit}), blind-row dq "
                    f"{blind}")
            if dtype == torch.bfloat16 and name in ("path", "llama path"):
                worst[name] = {"flash_attention_bwd_dq": errs[0][0],
                               "flash_attention_bwd_dkv": max(errs[1][0],
                                                              errs[2][0])}
            del q, k, v, do
    _bwd_deterministic(fa, gen)

    # timing at both path shapes, bf16, causal: the kernels line carries
    # the GPT-2 345M training shape, with the LLaMA-770M shape under
    # "shapes"
    timed = [(case, _time_bwd(fa, gen, shape))
             for case, shape in (("path", TRAIN_SHAPE),
                                 ("llama path", LLAMA_ATTN_SHAPE))]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        rows = [dict(timing[name], max_abs_err=worst[case][name])
                for case, timing in timed]
        state["kernels"][name] = dict(rows[0], shapes=rows)


def _bwd_deterministic(fa, gen):
    """Two calls of K2 and K3 on one input give bitwise-equal dq, dk and dv
    (no atomics: each sum runs in one order), in bf16 at a causal d=128
    shape with ragged tiles."""
    q, k, v, do = _bwd_inputs(2, 1000, 1000, 4, 128, torch.bfloat16, gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(out, do)
    runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=True)) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"  bwd bfloat16 two calls bitwise equal (dq, dk, dv): {same}")
    if not all(same):
        raise AssertionError(f"K2/K3 differ from call to call: {same}")


def _time_bwd(fa, gen, shape):
    """K2 and K3 at one path shape (bf16, causal): each one's time beside
    its bound, the plain backward and PyTorch's flash backward (one call
    that computes dQ, dK and dV: one time for the pair), and the host time
    a call; logs one row each and returns the kernels-line fields."""
    b, s, h, d = shape["b"], shape["s"], shape["h"], shape["d"]
    q, k, v, do = _bwd_inputs(b, s, s, h, d, torch.bfloat16, gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    delta = fa.flash_attention_bwd_delta(out, do)
    calls = {
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal=True),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal=True)}
    times = {name: (time_ms(fn, reps=KERNEL_REPS, queued=True), host_ms(fn))
             for name, fn in calls.items()}
    plain_ms, _, _ = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal=True), iters=5, queued=True)
    leaves, lib_out = _library_attention(q, k, v, True)
    lib_do = do.transpose(1, 2).contiguous()
    library_ms, _, _ = time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, lib_do, retain_graph=True), reps=KERNEL_REPS,
        queued=True)
    tensor_bytes = b * s * h * d * q.element_size()
    row_bytes = b * h * s * 4                       # lse or Delta
    pairs = _visible_pairs(s, s, True)
    plans = {
        # reads q, k, v, dO, lse, Delta; writes dQ. S, dP, dS K: 6d a pair
        "flash_attention_bwd_dq": (5 * tensor_bytes + 2 * row_bytes,
                                   6.0 * d * pairs * b * h),
        # reads the same; writes dK, dV. S, dP, P^T dO, dS^T Q: 8d a pair
        "flash_attention_bwd_dkv": (6 * tensor_bytes + 2 * row_bytes,
                                    8.0 * d * pairs * b * h),
    }
    label = f"B{b} S{s} H{h} d{d} bf16 causal"
    fields = {}
    for name, (moved, flops) in plans.items():
        (ms, q1, q3), host = times[name]
        bound_ms, bound_by = _bound(moved, flops)
        log(json.dumps({"kernel": name, "shape": label,
                        "kernel_ms": ms, "kernel_ms_q1": q1,
                        "kernel_ms_q3": q3, "host_ms_a_call": host,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms_dq_dk_dv": library_ms,
                        "plain_ms_dq_dk_dv": plain_ms, "bytes": moved,
                        "flops": flops}))
        fields[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms,
                            shape=label)
    k2_k3 = times["flash_attention_bwd_dq"][0][0] + \
        times["flash_attention_bwd_dkv"][0][0]
    log(json.dumps({"kernels": "flash_attention_bwd_dq + _dkv",
                    "shape": label, "kernel_ms": k2_k3,
                    "library_ms_dq_dk_dv": library_ms,
                    "ratio_to_library": k2_k3 / library_ms}))
    return fields


# ----------------------------------------------------------- fused_kernel
def _fused_check(name, case, dtype, got, ref):
    """Hold one K4-K7 call's outputs against its plain version's; returns
    the max abs error."""
    err, ratio = 0.0, 0.0
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name} {case}: {g.shape} {g.dtype} against "
                                 f"the plain version's {r.shape} {r.dtype}")
        diff = (g.float() - r.float()).abs()
        err = max(err, diff.max().item())
        if dtype == torch.float32:
            ratio = max(ratio, diff.max().item() / FUSED_FP32_TOL)
        else:
            ratio = max(ratio, (diff / (FUSED_REL[dtype] * r.float().abs()
                                        + FUSED_ABS)).max().item())
    tag = str(dtype).replace("torch.", "")
    log(f"  {name:20s} {tag:8s} {case:34s} max_abs_err={err:.3e} "
        f"limit_ratio={ratio:.3f}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name} disagrees with its plain version: {tag} "
                             f"{case}: max abs error {err}, {ratio:.3f} of "
                             f"its limit")
    return err


def _ordered(t):
    """A bf16/fp16 tensor's values as integers in their order (the
    sign-magnitude bits made two's complement): neighbours in the type
    differ by 1, and -0 and +0 are both 0."""
    bits = t.view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _rows_check(case, dtype, got, ref):
    """Check (a) of K6's split: the row pass's normalized values against
    the plain rows' (ROW_NEIGHBOURS, ROW_FP32_ABS); returns the max abs
    error."""
    diff = (got.float() - ref.float()).abs()
    steps = (_ordered(got) - _ordered(ref)).abs()
    near = int((steps == 1).sum())
    fine = int(((steps > 1) & (diff <= ROW_FP32_ABS)).sum())
    far = int(((steps > 1) & (diff > ROW_FP32_ABS)).sum())
    n = got.numel()
    tag = str(dtype).replace("torch.", "")
    log(f"  {'fused_norm_rows':20s} {tag:8s} {case:34s} "
        f"max_abs_err={diff.max().item():.3e} neighbours={near} "
        f"further_within_fp32={fine} further={far} of {n}")
    share_held = n * ROW_NEIGHBOURS >= 100
    if far or (share_held and near + fine > ROW_NEIGHBOURS * n):
        raise AssertionError(
            f"K6's row pass disagrees with its plain version: {tag} {case}: "
            f"{near} neighbours, {fine} further within {ROW_FP32_ABS}, "
            f"{far} further of {n}")
    return diff.max().item()


def _k6_split_check(fk, case, dtype, args):
    """K6 in bf16/fp16 with a norm, its two steps held apart: (a) the row
    pass against the plain rows, (b) the kernel's product against the
    plain product of the kernel's own rows, within the output limit; the
    whole chain against the plain K6 is printed, not held (a neighbour in
    the rows, times W, can pass the limit near 0). Returns the product's
    max abs error."""
    x, w, b, nw, nb, norm, act = args
    rows = fk.fused_norm_rows(x, nw, nb, norm)
    _rows_check(case, dtype, rows, fk.fused_norm_rows_plain(x, nw, nb, norm))
    got = fk.fused_matmul(*args)
    err = _fused_check("fused_matmul", case + " product", dtype, got,
                       fk.fused_matmul_plain(rows, w, b, act=act))
    whole = fk.fused_matmul_plain(*args).float()
    ratio = ((got.float() - whole).abs()
             / (FUSED_REL[dtype] * whole.abs() + FUSED_ABS)).max().item()
    tag = str(dtype).replace("torch.", "")
    log(f"  {'fused_matmul':20s} {tag:8s} {case + ' chain':34s} "
        f"limit_ratio={ratio:.3f} (printed, not held)")
    return err


def _fused_cases(fk, gen, dtype):
    """(kernel, case, check) at the path shapes of the fusion phase (the
    first case of each kernel) and at edge shapes; each check holds the
    kernel against its plain version and returns the max abs error."""
    def r(*shape, scale=1.0):
        return randn(shape, torch.float32, gen).mul_(scale).to(dtype)

    def held(name, case, run, plain):
        return name, case, lambda: _fused_check(name, case, dtype, run(),
                                                plain())
    cases = []
    for label, rows, d, kind, affine in (
            ("llama path rms 8192x1536", 8192, 1536, "rms_norm", "w"),
            ("gpt2 path ln 8192x1024", 8192, 1024, "layer_norm", "wb"),
            ("ragged ln 37x200", 37, 200, "layer_norm", "wb"),
            ("rms no affine 9x100", 9, 100, "rms_norm", "")):
        x, res = r(rows, d), r(rows, d)
        w = 1 + r(d, scale=0.1) if "w" in affine else None
        b = r(d, scale=0.1) if "b" in affine else None
        cases.append(held("fused_residual_norm", label,
                          lambda x=x, res=res, w=w, b=b, kind=kind:
                          fk.fused_residual_norm(x, res, w, b, kind=kind),
                          lambda x=x, res=res, w=w, b=b, kind=kind:
                          fk.fused_residual_norm_plain(x, res, w, b, kind)))
    for label, rows, d, acts in (("path 8192x4096", 8192, 4096, ("gelu",)),
                                 ("ragged 33x100", 33, 100, fk.ACT_CODE),
                                 ("64x4096", 64, 4096, fk.ACT_CODE)):
        x, b = r(rows, d), r(d, scale=0.5)
        for act in dict.fromkeys(a for a in acts if a):
            cases.append(held("fused_bias_act", f"{label} {act}",
                              lambda x=x, b=b, act=act:
                              fk.fused_bias_act(x, b, act),
                              lambda x=x, b=b, act=act:
                              fk.fused_bias_act_plain(x, b, act)))
    for label, m, k, n, norm, act, bias in (
            ("gpt2 fc1 8192x1024->4096 gelu_tanh", 8192, 1024, 4096, "",
             "gelu_tanh", True),
            ("gpt2 qkv ln 8192x1024->3072", 8192, 1024, 3072, "layer_norm",
             "", True),
            ("ragged ln 130x72->200", 130, 72, 200, "layer_norm", "gelu",
             True),
            ("rms silu 77x136->129 no bias", 77, 136, 129, "rms_norm",
             "silu", False),
            ("relu 1x64->8", 1, 64, 8, "", "relu", False),
            ("ragged M ln 300x1024->384", 300, 1024, 384, "layer_norm",
             "gelu_tanh", True),
            ("unaligned rows 64x256->4100", 64, 256, 4100, "", "gelu",
             True),
            ("rms 37x128->8 no bias", 37, 128, 8, "rms_norm", "", False),
            ("K=8 silu 50x8->136", 50, 8, 136, "", "silu", True),
            ("M=1 rms relu 1x1024->256", 1, 1024, 256, "rms_norm", "relu",
             True)):
        x, w = r(m, k), r(n, k, scale=k ** -0.5)
        b = r(n, scale=0.1) if bias else None
        nw = 1 + r(k, scale=0.1) if norm else None
        nb = r(k, scale=0.1) if norm else None
        args = (x, w, b, nw, nb, norm, act)
        if norm and dtype != torch.float32:     # the row pass, then the product
            cases.append(("fused_matmul", label,
                          lambda a=args, label=label:
                          _k6_split_check(fk, label, dtype, a)))
        else:
            cases.append(held("fused_matmul", label,
                              lambda a=args: fk.fused_matmul(*a),
                              lambda a=args: fk.fused_matmul_plain(*a)))
    for label, bt, s, k, heads, hd, off, bias in (
            ("llama q 8192x1536->1536 hd128", 4, 2048, 1536, 12, 128, 0,
             False),
            ("hd64 off5 bias 2x33 136->192", 2, 33, 136, 3, 64, 5, True),
            ("hd128 off7 2x64 256->256", 2, 64, 256, 2, 128, 7, False),
            # the wgmma body's edges: ragged M (rows not a multiple of
            # 128), N not a multiple of 128, K not a multiple of 64 and
            # K = 8, head dims 16 and 32, a large offset (angles past 6000
            # rad), the small LLaMA's GQA k projection
            ("ragged M 3x100 hd128 256->256 bias", 3, 100, 256, 2, 128, 0,
             True),
            ("hd64x3 N=192 2x64 256->192", 2, 64, 256, 3, 64, 0, False),
            ("K=136 hd128 2x80 136->384", 2, 80, 136, 3, 128, 2, False),
            ("K=8 hd32 bias 2x40 8->64", 2, 40, 8, 2, 32, 0, True),
            ("hd16 off3 bias 2x50 64->64", 2, 50, 64, 4, 16, 3, True),
            ("hd32 off9 3x100 136->96", 3, 100, 136, 3, 32, 9, False),
            ("off4000 hd128 2x2048 256->256", 2, 2048, 256, 2, 128, 4000,
             False),
            ("gqa k 2x512 1024->512 hd128", 2, 512, 1024, 4, 128, 0,
             False)):
        x, w = r(bt * s, k), r(heads * hd, k, scale=k ** -0.5)
        b = r(heads * hd, scale=0.1) if bias else None
        kw = dict(seq=s, head_dim=hd, pos_offset=off)
        cases.append(held("fused_matmul_rope", label,
                          lambda x=x, w=w, b=b, kw=kw:
                          fk.fused_matmul_rope(x, w, b, **kw),
                          lambda x=x, w=w, b=b, kw=kw:
                          fk.fused_matmul_rope_plain(x, w, b, **kw)))
    return cases


def _rope_deterministic(fk, gen):
    """Two K7 calls on one input give bitwise-equal outputs (no atomics:
    each sum runs in one order), in bf16 with ragged rows and a bias."""
    x = randn((300, 1536), torch.bfloat16, gen)
    w = (torch.randn((1536, 1536), generator=gen, device="cuda")
         * 1536 ** -0.5).to(torch.bfloat16)
    b = randn((1536,), torch.bfloat16, gen)
    runs = [fk.fused_matmul_rope(x, w, b, seq=150, head_dim=128,
                                 pos_offset=11) for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(*runs)
    log(f"  fused_matmul_rope bfloat16 two calls bitwise equal: {same}")
    if not same:
        raise AssertionError("K7 differs from call to call")


def _time_fused(name, label, run, plain, library, library_call, moved, flops,
                peak=BF16_FLOP_PER_S):
    """One K4-K7 timing at its path shape: the kernel (ten launches back to
    back a CUDA-event pair, queued), its plain version and a PyTorch
    yardstick."""
    ms, q1, q3 = time_ms(run, reps=KERNEL_REPS, queued=True)
    host = host_ms(run)
    plain_ms, _, _ = time_ms(plain, iters=5, queued=True)
    library_ms, _, _ = time_ms(library, reps=KERNEL_REPS, queued=True)
    bound_ms, bound_by = _bound(moved, flops, peak)
    log(json.dumps({"kernel": name, "shape": label, "kernel_ms": ms,
                    "kernel_ms_q1": q1, "kernel_ms_q3": q3,
                    "host_ms_a_call": host,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, "library_call": library_call,
                    "plain_ms": plain_ms, "bytes": moved, "flops": flops}))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, shape=label)


def phase_fused_kernel(state):
    import paddle_tpu_torch.ops.cuda.fused_ops as fk
    from paddle_tpu_torch.models.llama import rope_rotate
    TF = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        seen = set()
        for name, case, check in _fused_cases(fk, gen, dtype):
            err = check()
            if dtype == torch.bfloat16 and name not in seen:   # path shape
                worst[name] = err
            seen.add(name)
        torch.cuda.empty_cache()
    _rope_deterministic(fk, gen)

    bf16 = torch.bfloat16
    rows = LLAMA_SHAPE["b"] * LLAMA_SHAPE["s"]        # = 8 x 1024 for GPT-2
    h, d_gpt, ffn = LLAMA_770M["hidden_size"], 1024, 4096

    def r(*shape, scale=1.0):
        return randn(shape, torch.float32, gen).mul_(scale).to(bf16)
    # K4: LLaMA's residual + RMSNorm, 8192 x 1536 (x, res read; y, s written)
    x, res, w = r(rows, h), r(rows, h), 1 + r(h, scale=0.1)
    timed = {"fused_residual_norm": _time_fused(
        "fused_residual_norm", f"{rows}x{h} bf16 rms_norm",
        lambda: fk.fused_residual_norm(x, res, w, kind="rms_norm", eps=1e-6),
        lambda: fk.fused_residual_norm_plain(x, res, w, None, "rms_norm",
                                             1e-6),
        lambda: TF.rms_norm(x + res, (h,), w, 1e-6),
        "x + res, then F.rms_norm (two calls)",
        4 * rows * h * 2 + h * 2, 8.0 * rows * h, FP32_FLOP_PER_S)}
    xg, resg, wg, bg = r(rows, d_gpt), r(rows, d_gpt), 1 + r(d_gpt), r(d_gpt)
    _time_fused("fused_residual_norm", f"{rows}x{d_gpt} bf16 layer_norm",
                lambda: fk.fused_residual_norm(xg, resg, wg, bg),
                lambda: fk.fused_residual_norm_plain(xg, resg, wg, bg),
                lambda: TF.layer_norm(xg + resg, (d_gpt,), wg, bg, 1e-5),
                "x + res, then F.layer_norm (two calls)",
                4 * rows * d_gpt * 2 + 2 * d_gpt * 2, 9.0 * rows * d_gpt,
                FP32_FLOP_PER_S)
    # K5: the bias_act program's gelu(x W + b) epilogue, 8192 x 4096
    xb, bb = r(rows, ffn), r(ffn, scale=0.5)
    timed["fused_bias_act"] = _time_fused(
        "fused_bias_act", f"{rows}x{ffn} bf16 gelu",
        lambda: fk.fused_bias_act(xb, bb, "gelu"),
        lambda: fk.fused_bias_act_plain(xb, bb, "gelu"),
        lambda: TF.gelu(xb + bb), "F.gelu(x + b) (two calls)",
        2 * rows * ffn * 2 + ffn * 2, 20.0 * rows * ffn, FP32_FLOP_PER_S)
    # K6: GPT-2 345M fc1 with its gelu_tanh epilogue, and block 0's
    # LayerNorm -> qkv projection
    xm, wm, bm = r(rows, d_gpt), r(ffn, d_gpt, scale=d_gpt ** -0.5), r(ffn)
    timed["fused_matmul"] = _time_fused(
        "fused_matmul", f"{rows}x{d_gpt}->{ffn} bf16 bias gelu_tanh",
        lambda: fk.fused_matmul(xm, wm, bm, act="gelu_tanh"),
        lambda: fk.fused_matmul_plain(xm, wm, bm, act="gelu_tanh"),
        lambda: TF.gelu(torch.addmm(bm, xm, wm.t()), approximate="tanh"),
        "torch.addmm, then F.gelu (two calls)",
        (rows * d_gpt + ffn * d_gpt + rows * ffn + ffn) * 2,
        2.0 * rows * ffn * d_gpt)
    wq, bq = r(3 * d_gpt, d_gpt, scale=d_gpt ** -0.5), r(3 * d_gpt)
    _time_fused("fused_matmul", f"{rows}x{d_gpt}->{3 * d_gpt} bf16 "
                "layer_norm prologue, bias",
                lambda: fk.fused_matmul(xm, wq, bq, wg, bg, "layer_norm"),
                lambda: fk.fused_matmul_plain(xm, wq, bq, wg, bg,
                                              "layer_norm"),
                lambda: torch.addmm(bq, TF.layer_norm(xm, (d_gpt,), wg, bg),
                                    wq.t()),
                "F.layer_norm, then torch.addmm (two calls)",
                (rows * d_gpt + 3 * d_gpt * d_gpt + rows * 3 * d_gpt
                 + 3 * d_gpt + 2 * d_gpt) * 2,
                2.0 * rows * 3 * d_gpt * d_gpt)
    # K7: LLaMA-770M's q (and k) projection with its rope, 8192 x 1536
    xr, wr = r(rows, h), r(h, h, scale=h ** -0.5)
    seq, hd = LLAMA_SHAPE["s"], h // LLAMA_770M["num_heads"]
    timed["fused_matmul_rope"] = _time_fused(
        "fused_matmul_rope", f"{rows}x{h}->{h} bf16 seq {seq} head_dim {hd}",
        lambda: fk.fused_matmul_rope(xr, wr, seq=seq, head_dim=hd),
        lambda: fk.fused_matmul_rope_plain(xr, wr, seq=seq, head_dim=hd),
        lambda: rope_rotate(torch.matmul(xr, wr.t()).view(
            LLAMA_SHAPE["b"], seq, h // hd, hd), 10000.0, 0),
        "torch.matmul, then the plain rope",
        (rows * h + h * h + rows * h) * 2, 2.0 * rows * h * h)
    # the product alone, a floor for K7 (not a yardstick: no rotation)
    matmul_ms, _, _ = time_ms(lambda: torch.matmul(xr, wr.t()),
                              reps=KERNEL_REPS, queued=True)
    log(json.dumps({"kernel": "fused_matmul_rope", "shape": f"{rows}x{h}->{h}",
                    "torch_matmul_alone_ms": matmul_ms,
                    "kernel_ms": timed["fused_matmul_rope"]["ms"]}))
    for name, row in timed.items():
        state.setdefault("kernels", {})[name] = dict(row,
                                                     max_abs_err=worst[name])


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
def _reference_greedy(forward, prompt, n_new):
    """Full-recompute greedy loop through ``forward(ids)`` (a model, or a
    function of the ids); keeps the top-two logit gap of each step."""
    ids = list(prompt)
    toks, gaps = [], []
    with torch.inference_mode():
        for _ in range(n_new):
            ids_t = torch.tensor([ids], device="cuda")
            logits = forward(ids_t)[0, -1].float()
            top = torch.topk(logits, 2).values
            nxt = int(torch.argmax(logits))
            toks.append(nxt)
            gaps.append(float(top[0] - top[1]))
            ids.append(nxt)
    return toks, gaps


def _hold(label, got, ref, gap_at):
    """Every request's tokens equal ``ref``'s, or first differ at a near
    tie: ``gap_at(i, j)`` is the top-two logit gap of request i's step j
    in the reference, which must be below TOP2_GAP there."""
    for i, (toks, want) in enumerate(zip(got, ref)):
        if toks == want:
            continue
        j = next(j for j, (a, b) in enumerate(zip(toks, want)) if a != b)
        gap = gap_at(i, j)
        if gap >= TOP2_GAP:
            raise AssertionError(
                f"{label}: request {i}: token {toks[j:j + 1]} != reference "
                f"{want[j:j + 1]} at step {j} (top-two gap {gap:.3e})")
        log(f"  {label}: request {i} diverges at step {j} on a near tie "
            f"(top-two gap {gap:.3e} < {TOP2_GAP}); accepted")


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


def _profile(label, fn, groups=None):
    """Run ``fn`` under torch.profiler; print the operators by device time
    and one JSON line with the device-busy share of the wall time and,
    for each of ``groups`` (name -> substrings of kernel names), its
    share of the device time."""
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
    shares = {}
    for group, keys in (groups or {}).items():
        secs = sum(e.self_device_time_total for e in on_device
                   if any(k in e.name.lower() for k in keys)) * 1e-6
        shares[group] = {"device_s": secs, "share": secs / busy}
    row = {"profile": label, "wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall, "device_ops": len(on_device),
           "host_kernel_launches": launches, "groups": shares}
    log(json.dumps(row))
    return row


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
    refs = [_reference_greedy(model, p, n_new) for p in prompts]
    _hold("serve", got, [r for r, _ in refs],
          lambda i, j: refs[i][1][j])
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


# ------------------------------------------------------------ serve_llama
# bench.py _bench_serving (:532-535): the JAX package's serving rung
LLAMA_SERVING = dict(vocab_size=32000, hidden_size=1024,
                     intermediate_size=2816, num_layers=16, num_heads=16,
                     max_seq_len=1024)
SAMPLED = dict(temperature=0.8, top_p=0.9)


def _llama_prompts():
    """bench.py's burst: 24 prompt lengths from RandomState(7) in
    [32, 192), tokens from RandomState(11)."""
    lens = np.random.RandomState(7).randint(32, 192, size=24)
    rng = np.random.RandomState(11)
    return [[int(t) for t in rng.randint(1, LLAMA_SERVING["vocab_size"],
                                         size=int(n))] for n in lens]


def _llama_engine(model, prompts, n_new, **kw):
    """A LlamaPagedEngine at bench.py's geometry for these requests."""
    from paddle_tpu_torch.inference import LlamaPagedEngine
    longest = max(len(p) for p in prompts)
    geometry = dict(max_batch=8, block_size=32, max_blocks_per_seq=64,
                    num_blocks=max(64, (longest + n_new) // 32 * 8 * 2))
    return LlamaPagedEngine(model, **dict(geometry, **kw))


def _run_engine(eng, prompts, n_new, requests=None):
    """Serve ``prompts`` to completion; (tokens per request, wall s)."""
    requests = requests or [{}] * len(prompts)
    rids = [eng.add_request(p, max_new_tokens=n_new, **r)
            for p, r in zip(prompts, requests)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    missing = [r for r in rids if r not in out or len(out[r]) != n_new]
    if missing:
        raise AssertionError(f"requests {missing} did not finish")
    return [out[r] for r in rids], wall


def _llama_rounded_kv(model):
    """The model's full-recompute forward with its post-rope K and V
    passed through kv_dequantize_int8(kv_quantize_int8(.)), what the int8
    engine's pages hold; attention through K1."""
    from paddle_tpu_torch.models.llama import rotary_embedding
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda.serving import (kv_dequantize_int8,
                                                   kv_quantize_int8)
    cfg, m = model.cfg, model.model
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.hidden_size // nh

    def rounded(t):
        return kv_dequantize_int8(*kv_quantize_int8(t)).to(t.dtype)

    def forward(ids):
        B, S = ids.shape
        x = m.embed_tokens(ids)
        for blk in m.layers:
            att, ln = blk.self_attn, blk.input_layernorm(x)
            q = rotary_embedding(att.q_proj(ln).view(B, S, nh, hd),
                                 cfg.rope_theta)
            k = rounded(rotary_embedding(att.k_proj(ln).view(B, S, nkv, hd),
                                         cfg.rope_theta))
            v = rounded(att.v_proj(ln).view(B, S, nkv, hd))
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
            out, _ = F.flash_attention(q, k, v, causal=True)
            x = x + att.o_proj(out.reshape(B, S, nh * hd))
            x = x + blk.mlp(blk.post_attention_layernorm(x))
        return model._head(m.norm(x))
    return forward


def _top2_gap(model, ids):
    """The top-two gap of the model's next-token logits after ``ids``."""
    with torch.inference_mode():
        logits = model(torch.tensor([ids], device="cuda"))[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def phase_serve_llama(state):
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import SchedulerConfig

    marks = [time.perf_counter()]

    def lap():
        """Seconds since the previous lap (each check logs its own)."""
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    cfg = LlamaConfig(**LLAMA_SERVING, use_flash_attention=True)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0).eval()
    log(f"serve_llama: fp32 model built ({lap():.1f} s)")
    prompts = _llama_prompts()
    p8, n_new = prompts[:8], 32

    def near_tie_vs(ref, prompts_):      # gaps of the fp32 model at the ref
        return lambda i, j: _top2_gap(model, prompts_[i] + ref[i][:j])

    # 1. fp32 greedy against a full-recompute loop through model(ids), K1
    plain_eng = _llama_engine(model, p8, n_new)
    plain, _ = _run_engine(plain_eng, p8, n_new)
    before = fa.flash_attention_fwd.launches
    refs = [_reference_greedy(model, p, n_new) for p in p8]
    k1 = fa.flash_attention_fwd.launches - before
    if k1 != cfg.num_layers * n_new * len(p8):
        raise AssertionError(f"the reference loop launched K1 {k1} times")
    _hold("serve_llama fp32", plain, [r for r, _ in refs],
          lambda i, j: refs[i][1][j])
    log(f"serve_llama: fp32 greedy tokens of {len(p8)} requests (prompt "
        f"lengths {[len(p) for p in p8]}) match the full-recompute loop "
        f"({k1} K1 launches at d={cfg.hidden_size // cfg.num_heads}; "
        f"{lap():.1f} s)")

    # 2. int8 pages against a loop whose K/V are rounded as the pages are
    int8_eng = _llama_engine(model, p8, n_new, kv_dtype="int8")
    int8, _ = _run_engine(int8_eng, p8, n_new)
    rounded = _llama_rounded_kv(model)
    refs8 = [_reference_greedy(rounded, p, n_new) for p in p8]
    _hold("serve_llama int8", int8, [r for r, _ in refs8],
          lambda i, j: refs8[i][1][j])
    bf16_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * 2 * (
        cfg.hidden_size // cfg.num_heads)
    same = sum(a == b for x, y in zip(plain, int8) for a, b in zip(x, y))
    log(f"serve_llama: int8 KV tokens match the rounded-K/V loop; "
        f"kv_bytes_per_token {int8_eng.kv_bytes_per_token} = "
        f"{int8_eng.kv_bytes_per_token / plain_eng.kv_bytes_per_token:.4f}"
        f" of fp32's, {int8_eng.kv_bytes_per_token / bf16_bytes:.4f} of "
        f"bf16's; {same} of {len(p8) * n_new} tokens equal to the fp32 "
        f"pages' "
        f"({lap():.1f} s)")

    # 3. speculative decoding on the prompts repeated three times
    rep = [p * 3 for p in p8]
    base_eng = _llama_engine(model, rep, n_new)
    base, _ = _run_engine(base_eng, rep, n_new)
    spec_eng = _llama_engine(model, rep, n_new, speculate="ngram",
                             speculate_k=4)
    spec, _ = _run_engine(spec_eng, rep, n_new)
    _hold("serve_llama speculative", spec, base, near_tie_vs(base, rep))
    if not spec_eng.spec_proposed:
        raise AssertionError("the n-gram proposer never drafted")
    log(f"serve_llama: speculative (k=4) tokens match plain decode; "
        f"spec_proposed {spec_eng.spec_proposed}, spec_accepted "
        f"{spec_eng.spec_accepted}, ticks {spec_eng._ticks} against "
        f"{base_eng._ticks} plain ({lap():.1f} s)")

    # 4. the scheduler: one 32-token chunk of prefill a tick
    sched = _llama_engine(model, p8, n_new, scheduler=SchedulerConfig(
        prefill_token_budget=32))
    first = sched.add_request(p8[0], max_new_tokens=n_new)
    while sched._prefilling or sched.queue or not sched.slots[0]:
        sched.step()
    running = sched.slots[0]
    rids = [first] + [sched.add_request(p, max_new_tokens=n_new)
                      for p in p8[1:]]
    out, overlapped = {}, 0
    while sched.has_work():
        before = len(running.generated)
        prefilling = bool(sched._prefilling or sched.queue)
        out.update(sched.step())
        if running.status == "RUNNING" or before < n_new:
            if len(running.generated) != min(before + 1, n_new):
                raise AssertionError("decode starved while prompts "
                                     "prefilled")
            overlapped += prefilling
    budgeted = [out[r] for r in rids]
    _hold("serve_llama scheduler", budgeted, plain, near_tie_vs(plain, p8))
    if not sched.scheduler.deferred_chunks or not overlapped:
        raise AssertionError("the budget deferred no chunk")
    log(f"serve_llama: prefill_token_budget=32 tokens match plain decode; "
        f"deferred_chunks {sched.scheduler.deferred_chunks}; the running "
        f"request gained one token in each of the {overlapped} ticks that "
        f"also prefilled; ticks {sched._ticks}, prefill_tokens "
        f"{sched.scheduler.prefill_tokens}, decode_tokens "
        f"{sched.scheduler.decode_tokens} ({lap():.1f} s)")

    # 5. sampling: reproducible, unchanged by preemption, seed-dependent
    def sample(ps, n, seed, **kw):
        eng = _llama_engine(model, ps, n, seed=seed, **kw)
        return _run_engine(eng, ps, n, [SAMPLED] * len(ps))[0], eng
    a, _ = sample(p8, 16, 123)
    if a != sample(p8, 16, 123)[0]:
        raise AssertionError("two sampled runs under seed 123 differ")
    if a == sample(p8, 16, 124)[0]:
        raise AssertionError("seeds 123 and 124 sampled the same tokens")
    # three requests whose prefixes fill the pool exactly: each must take
    # a new block within 40 tokens, so every slot stalls and one is evicted
    trio = [p for p in p8 if len(p) % 32][:3]
    roomy, _ = sample(trio, 40, 123)
    usable = sum(-(-len(p) // 32) for p in trio)
    tight, tight_eng = sample(trio, 40, 123, max_batch=3,
                              num_blocks=usable + 1)
    if tight_eng.evictions < 1 or tight != roomy:
        raise AssertionError(f"preemption changed the sampled tokens "
                             f"(evictions {tight_eng.evictions})")
    log(f"serve_llama: sampling (temperature 0.8, top_p 0.9) reproduces "
        f"under seed 123, differs under 124, and is unchanged by "
        f"{tight_eng.evictions} evictions ({lap():.1f} s)")
    del plain_eng, int8_eng, base_eng, spec_eng, sched, tight_eng

    # 6. bf16, timed: bench.py's whole burst, 96 new tokens each
    card = _card_line()
    bf16 = model.to(torch.bfloat16)         # the same weights, rounded
    del model
    torch.cuda.empty_cache()
    n_burst = 96
    plain16 = None
    for name, kw in (("plain", {}), ("int8", dict(kv_dtype="int8")),
                     ("speculative", dict(speculate="ngram",
                                          speculate_k=4))):
        eng = _llama_engine(bf16, prompts, n_burst, **kw)
        _run_engine(eng, prompts[:1], 4)                   # warm-up
        eng.phase_seconds = {"prefill": [], "decode": []}
        ticks0, prop0, acc0 = eng._ticks, eng.spec_proposed, eng.spec_accepted
        if state.get("profile") and name == "plain":
            _profile("serve_llama bf16, 8 requests",
                     lambda: _run_engine(eng, prompts[:8], 32))
            eng.phase_seconds = {"prefill": [], "decode": []}
            ticks0 = eng._ticks
        toks, wall = _run_engine(eng, prompts, n_burst)
        plain16 = plain16 or toks
        generated = len(prompts) * n_burst
        row = {"serve_llama": f"bench.py _bench_serving LLaMA bf16 {name}",
               "requests": len(prompts), "new_tokens": n_burst,
               "max_batch": 8, "block_size": 32,
               "num_blocks": eng._total_usable + 1,
               "wall_s": wall, "tokens_per_s": generated / wall,
               "decode_tick_ms_median":
                   statistics.median(eng.phase_seconds["decode"]) * 1e3,
               "prefill_chunk_ms_median":
                   statistics.median(eng.phase_seconds["prefill"]) * 1e3,
               "ticks": eng._ticks - ticks0,
               "decode_programs": len(eng.phase_seconds["decode"]),
               "prefill_programs": len(eng.phase_seconds["prefill"]),
               "kv_bytes_per_token": eng.kv_bytes_per_token,
               "evictions": eng.evictions,
               "tokens_equal_to_plain": sum(
                   a == b for x, y in zip(plain16, toks)
                   for a, b in zip(x, y)) / generated,
               "card": card}
        if name == "speculative":
            row.update(spec_proposed=eng.spec_proposed - prop0,
                       spec_accepted=eng.spec_accepted - acc0)
        log(json.dumps(row))
        del eng
    del bf16
    torch.cuda.empty_cache()
    lap()
    log(f"serve_llama: phase took {marks[-1] - marks[0]:.1f} s")


# ------------------------------------------------------------- serve_tier
# bench.py _bench_serving_resilience / _bench_serving_router (:628-637,
# :711-721): the LLaMA of serve_llama without flash attention, 48 requests
# of 32-160 prompt tokens, 64 new tokens each, 8 slots, blocks of 32
TIER_REQUESTS = 48
TIER_NEW = 64
TIER_BATCH = 8
TIER_PROMPTS = (32, 160)
TIER_BLOCKS = (TIER_PROMPTS[1] + TIER_NEW + 31) // 32     # bench.py:641
# the router rung's requests (BENCH_REQUESTS), cut from 48 to 32 to keep
# the phase near 4 minutes: 48 took the rung 172 s of a 291 s phase
ROUTER_REQUESTS = 32
SATURATING_RPS = 10_000.0
REQTRACE_PAIRS = 150          # bench.py:887 (BENCH_REQTRACE_PAIRS)


def _tier_engine(model, max_queue, high_water=None, budget=None):
    """A PagedEngine at the rungs' geometry (bench.py:642-647, :723-733)."""
    from paddle_tpu_torch.inference import PagedEngine, ResilienceConfig
    from paddle_tpu_torch.serving import SchedulerConfig
    return PagedEngine(
        model, max_batch=TIER_BATCH, block_size=32,
        num_blocks=max(64, TIER_BLOCKS * TIER_BATCH * 2),
        max_blocks_per_seq=max(TIER_BLOCKS + 1, 8),
        scheduler=SchedulerConfig(prefill_token_budget=budget)
        if budget else None,
        resilience=ResilienceConfig(max_queue=max_queue,
                                    queue_high_water=high_water))


def _tier_replica(model, max_queue):
    """A router replica (bench.py:723-733): one chunk batch of prefill a
    tick and no high-water mark, so that the router owns shedding."""
    return _tier_engine(model, max_queue, budget=32 * TIER_BATCH)


def _clean(label, engines):
    """No tick failure, no FAILED outcome left, no KV block held."""
    for eng in engines:
        if eng.tick_failures:
            raise AssertionError(f"{label}: {eng.lifecycle.name} contained "
                                 f"{eng.tick_failures} tick failures: "
                                 f"{eng.last_tick_failure!r}")
        h = eng.health()
        if h["kv_blocks_free"] != h["kv_blocks_total"]:
            raise AssertionError(f"{label}: {eng.lifecycle.name} leaked "
                                 f"{h['kv_blocks_total'] - h['kv_blocks_free']}"
                                 f" KV blocks")


def _load_point(label, engine, engines, card, **kw):
    """One run_load point: every submitted request terminal, none FAILED,
    no tick failure, no KV block leaked; one JSON line."""
    from paddle_tpu_torch.tools.loadgen import run_load
    common = dict(n_requests=TIER_REQUESTS, vocab_size=LLAMA_SERVING[
        "vocab_size"], prompt_len_range=TIER_PROMPTS,
        max_new_tokens=TIER_NEW, seed=13)
    report = run_load(engine, **dict(common, **kw))
    if sum(report["outcomes"].values()) != report["submitted"]:
        raise AssertionError(f"{label}: {report['outcomes']} do not account "
                             f"for {report['submitted']} submissions")
    if report["failed"]:
        raise AssertionError(f"{label}: {report['failed']} requests FAILED")
    _clean(label, engines)
    row = {"serve_tier": label, **{k: report[k] for k in (
        "offered_rps", "achieved_arrival_rps", "n_requests", "submitted",
        "overloaded", "outcomes", "finished", "shed", "deadline_missed",
        "goodput_tokens_per_sec", "goodput_requests_per_sec", "p50_ttft_s",
        "p99_ttft_s", "p50_itl_s", "p99_itl_s", "wall_s",
        "device_attribution", "p99_ttft_exemplar", "router")},
        "card": card}
    log(json.dumps(row))
    return report


def _tier_parity(model, lap):
    """fp32: a Router of 2 replicas and a TokenStream against a plain
    engine, up to near ties; every timeline complete, router timelines
    stitched with their replica legs."""
    from paddle_tpu_torch.observability import reqtrace
    from paddle_tpu_torch.serving import Router
    prompts, n_new = _llama_prompts()[:8], 16
    reqtrace.RECORDER.clear()
    plain_eng = _tier_engine(model, 64)
    plain, _ = _run_engine(plain_eng, prompts, n_new)

    def near_tie(i, j):
        return _top2_gap(model, prompts[i] + plain[i][:j])

    router = Router([_tier_engine(model, 64) for _ in range(2)]).warmup()
    rids = [router.add_request(p, max_new_tokens=n_new) for p in prompts]
    router.run_to_completion()
    outcomes = router.drain_outcomes()
    if any(outcomes[r].status != "FINISHED" for r in rids):
        raise AssertionError("serve_tier: router requests did not finish")
    _hold("serve_tier router fp32", [outcomes[r].tokens for r in rids],
          plain, near_tie)
    routed = [r["routed"] for r in router.stats()["per_replica"]]
    if min(routed) == 0:
        raise AssertionError(f"serve_tier: routing {routed} used one replica")
    stitched = 0
    for rid in rids:
        tl = reqtrace.stitch(reqtrace.RECORDER.timeline(router.name, rid))
        legs = {e["scope"] for e in tl["events"]} - {router.name}
        problems = reqtrace.validate(tl)
        if problems or not legs:
            raise AssertionError(f"serve_tier: router rid {rid}: legs "
                                 f"{legs}, {problems}")
        stitched += 1

    eng = _tier_engine(model, 64)
    srids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    stream = eng.stream(srids[3])
    streamed = list(stream)
    eng.run_to_completion()
    if stream.status != "FINISHED" or streamed != eng.outcomes[srids[3]].tokens:
        raise AssertionError(f"serve_tier: stream ended {stream.status} with "
                             f"{len(streamed)} tokens")
    _hold("serve_tier stream fp32", [streamed], [plain[3]],
          lambda i, j: near_tie(3, j))
    checked = 0
    for e in [plain_eng, eng] + router.replicas:
        for rid in e.outcomes:
            problems = reqtrace.validate(
                reqtrace.RECORDER.timeline(e.reqtrace_scope, rid))
            if problems:
                raise AssertionError(f"serve_tier: {e.reqtrace_scope} rid "
                                     f"{rid}: {problems}")
            checked += 1
    router.drain()
    _clean("serve_tier parity", [plain_eng, eng] + router.replicas)
    log(f"serve_tier: fp32 router (2 replicas, routed {routed}) and stream "
        f"tokens match a plain engine for {len(prompts)} requests of "
        f"{n_new} tokens; {stitched} router timelines stitched, {checked} "
        f"replica timelines complete ({lap():.1f} s)")


def _reqtrace_overhead(model, card, lap):
    """bench.py _bench_serving_reqtrace (:857-953), fp32: one full batch
    of long-running requests, each decode tick timed with FLAGS_reqtrace
    off and on in pairs whose order alternates; the median tick off and
    the median of the paired differences."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import PagedEngine
    from paddle_tpu_torch.observability import reqtrace
    warm, bs, prompt_len = 20, 16, 8
    ticks_needed = warm + 2 * REQTRACE_PAIRS + 16
    bps = -(-(prompt_len + ticks_needed + bs) // bs) + 1
    eng = PagedEngine(model, max_batch=TIER_BATCH, block_size=bs,
                      num_blocks=TIER_BATCH * bps + 2, max_blocks_per_seq=bps)
    rng = np.random.RandomState(3)
    for _ in range(TIER_BATCH):
        eng.add_request([int(t) for t in rng.randint(
            1, LLAMA_SERVING["vocab_size"], size=prompt_len)],
            max_new_tokens=ticks_needed)

    def one_tick():
        t0 = time.perf_counter()
        eng.step()
        return time.perf_counter() - t0

    t_off, diffs = [], []
    reqtrace.RECORDER.clear()
    try:
        for _ in range(warm):
            eng.step()
        for i in range(REQTRACE_PAIRS):
            order = (False, True) if i % 2 == 0 else (True, False)
            took = {}
            for on in order:
                ptt.set_flags({"FLAGS_reqtrace": on})
                took[on] = one_tick()
            t_off.append(took[False])
            diffs.append(took[True] - took[False])
        recorded = sum(len(tl["events"])
                       for tl in reqtrace.RECORDER.live_timelines())
    finally:
        ptt.set_flags({"FLAGS_reqtrace": True})
    eng.drain()
    reqtrace.RECORDER.clear()
    reqtrace.EXEMPLARS.clear()
    _clean("serve_tier reqtrace", [eng])
    off = statistics.median(t_off)
    on = off + statistics.median(diffs)
    log(json.dumps({
        "serve_tier": "bench.py _bench_serving_reqtrace LLaMA fp32",
        "pairs": REQTRACE_PAIRS, "batch": TIER_BATCH,
        "tick_off_ms": off * 1e3, "tick_on_ms": on * 1e3,
        "off_over_on": off / on, "overhead_pct": (on / off - 1) * 100,
        "events_recorded": recorded, "card": card}))
    if not recorded:
        raise AssertionError("serve_tier: the traced ticks recorded nothing")
    log(f"serve_tier: reqtrace overhead measured ({lap():.1f} s)")


def _tier_drills(model, lap):
    """bf16: a crash fails exactly the in-flight requests, reallocates
    the pages and degrades, and the next requests get a fresh engine's
    tokens; a stall past the watchdog's timeout degrades and recover()
    readies; drain() stops with every KV block free."""
    from paddle_tpu_torch.distributed.watchdog import Watchdog
    from paddle_tpu_torch.fault import inject
    prompts, n_new = _llama_prompts()[:12], 16

    eng = _tier_engine(model, 64).warmup()
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    for _ in range(3):
        eng.step()
    in_flight = {s.rid for s in eng.slots if s is not None}
    queued = {r.rid for r in eng.queue}
    tick = eng._ticks + 1
    with inject.armed("serving.crash_at_tick", tick=tick):
        eng.step()
    failed = {r for r, oc in eng.outcomes.items() if oc.status == "FAILED"}
    want = f"tick {tick} failed: InjectedFault('injected crash at tick {tick}')"
    exc = eng.last_tick_failure
    if (failed != in_flight or not in_flight
            or any(eng.outcomes[r].detail != want for r in failed)
            or not isinstance(exc, inject.InjectedFault)
            or exc.point != "serving.crash_at_tick"):
        raise AssertionError(f"serve_tier crash drill: FAILED {sorted(failed)}"
                             f", in flight {sorted(in_flight)}, contained "
                             f"{exc!r}")
    if eng.lifecycle.state != "DEGRADED" or eng.tick_failures != 1:
        raise AssertionError(f"serve_tier crash drill: {eng.health()}")
    if any(bool(t.any()) for t in eng.kc + eng.vc):
        raise AssertionError("serve_tier crash drill: pages not fresh")
    survivors = eng.run_to_completion()
    if set(survivors) != queued:
        raise AssertionError(f"serve_tier crash drill: queued {sorted(queued)}"
                             f" finished {sorted(survivors)}")
    after, _ = _run_engine(eng, prompts[:4], n_new)
    fresh, _ = _run_engine(_tier_engine(model, 64), prompts[:4], n_new)
    if after != fresh:
        raise AssertionError("serve_tier crash drill: tokens after the crash "
                             "differ from a fresh engine's")
    eng.recover()
    log(f"serve_tier: crash drill at tick {tick} failed exactly the "
        f"{len(in_flight)} in-flight requests, reallocated the pages, "
        f"finished the {len(queued)} queued, and 4 new requests match a "
        f"fresh engine ({lap():.1f} s)")

    hangs = []
    wd = Watchdog(timeout=0.5, poll_interval=0.05,
                  on_hang=lambda w: hangs.append(w.timeout)).start()
    try:
        eng.attach_watchdog(wd)
        _run_engine(eng, prompts[:8], n_new)
        if wd.hang_count or eng.lifecycle.state != "READY":
            raise AssertionError(f"serve_tier stall drill: a plain run "
                                 f"tripped the watchdog ({wd.hang_count})")
        rid = eng.add_request(prompts[0], max_new_tokens=4)
        with inject.armed("serving.tick_stall", seconds=1.5):
            eng.step()
        if not wd.hang_count or not hangs or eng.lifecycle.state != "DEGRADED":
            raise AssertionError(f"serve_tier stall drill: hangs "
                                 f"{wd.hang_count}, {eng.lifecycle.state}")
        eng.recover()
        out = eng.run_to_completion()
        if len(out.get(rid, ())) != 4 or eng.lifecycle.state != "READY":
            raise AssertionError("serve_tier stall drill: no recovery")
    finally:
        wd.stop()
    log(f"serve_tier: stall drill: a 1.5 s stall tripped the 0.5 s watchdog "
        f"({wd.hang_count} report), DEGRADED, recover() -> READY "
        f"({lap():.1f} s)")

    eng.drain()
    h = eng.health()
    if (h["state"] != "STOPPED" or h["kv_blocks_free"] != h["kv_blocks_total"]
            or h["tick_failures"] != 1):
        raise AssertionError(f"serve_tier drain: {h}")
    log(f"serve_tier: drain() -> STOPPED, {h['kv_blocks_free']} of "
        f"{h['kv_blocks_total']} KV blocks free ({lap():.1f} s)")


def _resilience_rung(model, card, lap):
    """bench.py _bench_serving_resilience (:602-689): the capacity probe,
    then 0.5x, 1x and 2x of its rate under deadlines sized from it."""
    eng = _tier_engine(model, 4 * TIER_REQUESTS, high_water=4 * TIER_BATCH)
    eng.warmup(prompt_len=TIER_PROMPTS[1] // 2, max_new_tokens=TIER_NEW)
    probe = _load_point("resilience probe", eng, [eng], card,
                        offered_rps=SATURATING_RPS)
    # bench.py probes with the high-water mark set: a burst that fills
    # the queue past it sheds there, and every other request finishes
    if (probe["finished"] + probe["shed"] != TIER_REQUESTS
            or probe["deadline_missed"] or probe["overloaded"]):
        raise AssertionError(f"serve_tier: the probe ended {probe['outcomes']}"
                             f" ({probe['overloaded']} overloaded)")
    cap_rps = max(probe["goodput_requests_per_sec"], 1e-3)
    ttft_dl = max((probe["p99_ttft_s"] or 0.01) * 8, 1e-3)
    total_dl = ttft_dl + 4 * TIER_NEW * (probe["p99_itl_s"] or 0.01)
    for mult in (0.5, 1.0, 2.0):
        _load_point(f"resilience {mult}x", eng, [eng], card,
                    offered_rps=mult * cap_rps, ttft_deadline_s=ttft_dl,
                    deadline_s=total_dl)
    eng.drain()
    _clean("serve_tier resilience", [eng])
    log(f"serve_tier: resilience rung: capacity {cap_rps:.3f} req/s, TTFT "
        f"deadline {ttft_dl:.4f} s, total {total_dl:.4f} s ({lap():.1f} s)")


def _router_rung(model, card, lap):
    """bench.py _bench_serving_router (:692-854): goodput at saturating
    arrivals for R=1 and R=2, then the 2x-overload curve at R=2 with the
    burst point; all shedding must be the router's."""
    from paddle_tpu_torch.serving import Router
    goodput = {}
    for r in (1, 2):
        reps = [_tier_replica(model, 8 * ROUTER_REQUESTS) for _ in range(r)]
        tier = Router(reps).warmup()
        goodput[r] = _load_point(f"router R={r} saturating", tier, reps,
                                 card, offered_rps=SATURATING_RPS,
                                 n_requests=2 * ROUTER_REQUESTS)
        tier.drain()
        if goodput[r]["finished"] != 2 * ROUTER_REQUESTS:
            raise AssertionError(f"serve_tier: the R={r} probe ended "
                                 f"{goodput[r]['outcomes']}")
    g1 = goodput[1]["goodput_tokens_per_sec"]
    g2 = goodput[2]["goodput_tokens_per_sec"]
    cap_rps = max(goodput[2]["goodput_requests_per_sec"], 1e-3)
    ttft_dl = max((goodput[2]["p99_ttft_s"] or 0.01) * 8, 1e-3)
    total_dl = ttft_dl + 4 * TIER_NEW * (goodput[2]["p99_itl_s"] or 0.01)
    replica_side_shed = shed_at_router = 0
    for mult, n in ((0.5, ROUTER_REQUESTS), (1.0, ROUTER_REQUESTS),
                    (2.0, ROUTER_REQUESTS), ("burst", 4 * ROUTER_REQUESTS)):
        reps = [_tier_replica(model, max(TIER_BATCH, 4)) for _ in range(2)]
        tier = Router(reps).warmup()
        rate = SATURATING_RPS if mult == "burst" else mult * cap_rps
        pt = _load_point(f"router R=2 {mult}" + ("" if mult == "burst"
                                                  else "x"),
                         tier, reps, card, offered_rps=rate, n_requests=n,
                         ttft_deadline_s=ttft_dl, deadline_s=total_dl)
        tier.drain()
        shed_at_router += pt["router"]["shed_at_router"]
        replica_side_shed += pt["shed"] - pt["router"]["shed_at_router"]
    log(json.dumps({"serve_tier": "router R=2 / R=1 goodput",
                    "requests": ROUTER_REQUESTS,
                    "goodput_tokens_per_sec_R1": g1,
                    "goodput_tokens_per_sec_R2": g2, "R2_over_R1": g2 / g1,
                    "shed_at_router_total": shed_at_router,
                    "replica_side_shed_total": replica_side_shed,
                    "card": card}))
    if replica_side_shed:
        raise AssertionError(f"serve_tier: {replica_side_shed} requests shed "
                             f"inside a replica")
    log(f"serve_tier: router rung: R=2/R=1 goodput {g2 / g1:.3f}, "
        f"{shed_at_router} shed at the router, none inside a replica "
        f"({lap():.1f} s)")


def phase_serve_tier(state):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    marks = [time.perf_counter()]

    def lap():
        marks.append(time.perf_counter())
        return marks[-1] - marks[-2]

    card = _card_line()
    cfg = LlamaConfig(**LLAMA_SERVING, use_flash_attention=False)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0).eval()
    log(f"serve_tier: fp32 model built ({lap():.1f} s)")
    _tier_parity(model, lap)
    _reqtrace_overhead(model, card, lap)
    bf16 = model.to(torch.bfloat16)         # the same weights, rounded
    del model
    torch.cuda.empty_cache()
    _tier_drills(bf16, lap)
    _resilience_rung(bf16, card, lap)
    _router_rung(bf16, card, lap)
    del bf16
    torch.cuda.empty_cache()
    log(f"serve_tier: phase took {marks[-1] - marks[0]:.1f} s")


# ------------------------------------------------------------------ train
def _wrapper(name):
    """The wrapper of kernel ``name``, which carries its launch count."""
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    import paddle_tpu_torch.ops.cuda.fused_ops as fk
    return getattr(fa if name.startswith("flash") else fk, name)


def _counts():
    return {name: _wrapper(name).launches for name in KERNELS}


def _launched(before, after):
    """Launches between two ``_counts()``, kernels that launched only."""
    return {n: after[n] - before[n] for n in KERNELS if after[n] != before[n]}


def _flash_launches(layers):
    """A step's launches without fusion: (forward, backward)."""
    return ({"flash_attention_fwd": layers},
            {"flash_attention_bwd_dq": layers,
             "flash_attention_bwd_dkv": layers})


def _no_decay(name):
    return not name.endswith(("bias", "ln1.weight", "ln2.weight",
                              "ln_f.weight"))


def _train_step(forward, opt, ids, want_fwd, want_bwd, events=None,
                grad_norms=None, amp_kw=None, scaler=None):
    """One eager step, forward(ids, labels=ids) -> backward -> AdamW; holds
    the launches of the forward and of the backward to ``want_fwd`` and
    ``want_bwd`` (kernel -> launches; every other kernel none). ``events``,
    four CUDA events, split the step into forward, backward and
    optimizer. ``grad_norms``, a list, gets the step's global gradient
    norm (fp32, on the card) appended. ``amp_kw``: the forward runs under
    ``amp.auto_cast(**amp_kw)``; ``scaler``: a ``GradScaler`` scales the
    loss and takes the optimizer's step."""
    from paddle_tpu_torch import amp
    c0 = _counts()
    if events:
        events[0].record()
    with amp.auto_cast(**amp_kw) if amp_kw else contextlib.nullcontext():
        _, loss = forward(ids, labels=ids)
    c1 = _counts()
    if events:
        events[1].record()
    (scaler.scale(loss) if scaler else loss).backward()
    c2 = _counts()
    if events:
        events[2].record()
    if grad_norms is not None:
        grads = [p.grad for p in opt._parameter_list if p.grad is not None]
        grad_norms.append(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=torch.float32))))
    if scaler:
        scaler.step(opt)
    else:
        opt.step()
    opt.clear_grad()
    if events:
        events[3].record()
    got_fwd, got_bwd = _launched(c0, c1), _launched(c1, c2)
    if got_fwd != want_fwd or got_bwd != want_bwd:
        raise AssertionError(
            f"launches in the forward {got_fwd}, in the backward {got_bwd}; "
            f"expected {want_fwd} and {want_bwd}")
    return loss


def _fp32_parity():
    """GPT-2 small fp32, card against a CPU twin with the same weights:
    3 AdamW steps on one seeded batch with a warm-up/cosine schedule and
    global-norm clipping; the per-step losses must agree."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import (AdamW, CosineAnnealingDecay,
                                            LinearWarmup)
    cfg = gpt2_small()
    card = GPTForCausalLM(cfg, device="cuda", seed=3).train()
    twin = GPTForCausalLM(cfg, device="cpu", seed=4).train()
    twin.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = torch.from_numpy(np.random.RandomState(11).randint(
        0, cfg.vocab_size, (2, 256)))
    losses = {}
    for name, model in (("card", card), ("cpu", twin)):
        sched = LinearWarmup(CosineAnnealingDecay(LR, T_max=10),
                             warmup_steps=2, start_lr=LR / 10, end_lr=LR)
        opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                    apply_decay_param_fun=_no_decay,
                    grad_clip=ClipGradByGlobalNorm(1.0), **ADAMW)
        batch = ids.to(next(model.parameters()).device)
        want = _flash_launches(cfg.num_layers) if name == "card" else ({}, {})
        losses[name] = []
        for _ in range(3):
            loss = _train_step(model, opt, batch, *want)
            sched.step()
            losses[name].append(float(loss.detach()))
    diff = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
    log(f"train: fp32 GPT-2 small B=2 S=256, 3 AdamW steps: card losses "
        f"{losses['card']}, CPU twin {losses['cpu']}, max diff {diff:.3e} "
        f"(tolerance {LOSS_TOL})")
    if not diff <= LOSS_TOL:
        raise AssertionError(f"fp32 training losses disagree: {diff}")


def phase_train(state):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_medium
    from paddle_tpu_torch.optimizer import AdamW

    _fp32_parity()

    # GPT-2 345M at full width and depth, bf16 weights with fp32 masters
    cfg = gpt2_medium()
    b, s, steps = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"], 10
    model = GPTForCausalLM(cfg, device="cuda", dtype="bfloat16",
                           seed=5).train()
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                multi_precision=True, **ADAMW)
    # two seeded batches in turn: each is seen five times, so the loss on
    # a repeated batch shows learning (on fresh uniform-random tokens
    # every step, 10 steps at 8,192 tokens a batch teach a batch nothing)
    pair = [torch.from_numpy(np.random.RandomState(100 + i).randint(
        0, cfg.vocab_size, (b, s))).cuda() for i in range(2)]
    batches = [pair[i % 2] for i in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    losses, walls, split = [], [], []
    for i in range(steps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _train_step(model, opt, batches[i],
                           *_flash_launches(cfg.num_layers), events)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        split.append([events[j].elapsed_time(events[j + 1])
                      for j in range(3)])
        losses.append(float(loss.detach()))
    with torch.no_grad():
        _, again = model(batches[0], labels=batches[0])
    again = float(again)
    log(f"train: GPT-2 345M bf16 losses {losses}; batch 0 again after "
        f"{steps} steps: {again}")
    if not all(np.isfinite(losses + [again])) or not again < losses[0]:
        raise AssertionError(f"345M training: loss {losses[0]} -> {again} "
                             f"on the repeated batch")
    timed = walls[2:]
    q1, median, q3 = statistics.quantiles(timed, n=4)
    tokens_per_s = b * s / median
    flops_per_token = model.flops_per_token()
    fwd, bwd, upd = (statistics.median(x[j] for x in split[2:])
                     for j in range(3))
    log(json.dumps({
        "train": "gpt2_medium bf16 AdamW(multi_precision) B8 S1024",
        "params": model.num_params(), "step_ms": median * 1e3,
        "step_ms_q1": q1 * 1e3, "step_ms_q3": q3 * 1e3,
        "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": upd,
        "tokens_per_s": tokens_per_s, "flops_per_token": flops_per_token,
        "mfu": flops_per_token * tokens_per_s / BF16_FLOP_PER_S,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_batch0_again": again}))
    if state.get("profile"):
        prof = _profile(
            "train step gpt2_medium bf16 B8 S1024",
            lambda: _train_step(model, opt, batches[1],
                                *_flash_launches(cfg.num_layers)),
            groups={"K1 flash_fwd": ("flash_fwd",),
                    "K2 dq": ("dq_wgmma", "dq_f32"),
                    "K3 dkv": ("dkv_wgmma", "dkv_f32"),
                    "GEMM": ("gemm", "nvjet", "cutlass", "xmma")})
        # the profiler's host cost stretches the profiled step's wall, so
        # the unprofiled busy share is estimated: the profiled step's
        # device time over this run's unprofiled median step
        log(json.dumps({"train_device_busy_share_est":
                        prof["device_busy_s"] / median,
                        "profiled_device_s": prof["device_busy_s"],
                        "unprofiled_step_s": median}))


# ----------------------------------------------------------------- fusion
def _fused_forward_parity(label, build, ids, want):
    """A small fp32 model through to_static with fusion on, on the card (the
    kernels) and on a CPU twin with the same weights (the kernels' plain
    versions): logits within LOGITS_TOL, the same pass stats, and the card's
    forward launches ``want``."""
    from paddle_tpu_torch import to_static
    card = build("cuda").eval()
    twin = build("cpu").eval()
    twin.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    on_card, on_cpu = to_static(card), to_static(twin)
    with torch.no_grad():
        on_card(ids.cuda())                     # the first call traces
        before = _counts()
        logits = on_card(ids.cuda()).float().cpu()
        got = _launched(before, _counts())
        ref = on_cpu(ids)
    diff = (logits - ref).abs().max().item()
    log(f"fusion: {label} fp32 logits, fused on the card vs fused CPU twin: "
        f"max_abs_diff={diff:.3e} (tolerance {LOGITS_TOL}); launches a "
        f"forward {got}; fusion_stats {on_card.fusion_stats}")
    if not torch.isfinite(logits).all() or diff > LOGITS_TOL:
        raise AssertionError(f"{label}: fused logits disagree: {diff}")
    if got != want or on_card.fusion_stats != on_cpu.fusion_stats:
        raise AssertionError(f"{label}: launches {got} (expected {want}), "
                             f"stats {on_card.fusion_stats} on the card, "
                             f"{on_cpu.fusion_stats} on the CPU")


def _fused_training(label, model, batches, fused_fwd, profile=False,
                    blocks=2, per_block=4):
    """Train ``model`` (bf16 weights, fp32 masters, AdamW) with the fused
    step (to_static, fusion on) and the unfused eager step in turns, on
    seeded batches taken in turn. Holds the step-1 losses to each other
    within FUSED_LOSS_TOL, every step's launches (the fused forward adds
    ``fused_fwd``), and a finite loss that falls on the repeated batch;
    logs each step's loss and global gradient norm, step times (the first
    step of each block warms its path up) and, with ``profile``, a profile
    of one step of each."""
    from paddle_tpu_torch import to_static
    from paddle_tpu_torch.optimizer import AdamW
    plain_fwd, bwd = _flash_launches(model.cfg.num_layers)
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                multi_precision=True, **ADAMW)
    fused = to_static(model)
    b0 = batches[0]
    with torch.no_grad():
        loss_u = float(model(b0, labels=b0)[1])
        loss_f = float(fused(b0, labels=b0)[1])       # traces
    log(f"fusion: {label} step-1 loss fused {loss_f} unfused {loss_u} "
        f"(tolerance {FUSED_LOSS_TOL}); fusion_stats {fused.fusion_stats}")
    if not abs(loss_f - loss_u) <= FUSED_LOSS_TOL:
        raise AssertionError(f"{label}: fused step-1 loss {loss_f} against "
                             f"unfused {loss_u}")
    runs = {"fused": (fused, dict(plain_fwd, **fused_fwd)),
            "unfused": (model, plain_fwd)}
    walls = {name: [] for name in runs}
    split = {name: [] for name in runs}
    losses, grad_norms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(blocks):
        for name, (forward, want_fwd) in runs.items():
            for k in range(per_block):
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(4)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = _train_step(forward, opt, batches[len(losses) % 2],
                                   want_fwd, bwd, events, grad_norms)
                torch.cuda.synchronize()
                if k:
                    walls[name].append(time.perf_counter() - t0)
                    split[name].append([events[j].elapsed_time(events[j + 1])
                                        for j in range(3)])
                losses.append(float(loss.detach()))
    with torch.no_grad():
        again = float(fused(b0, labels=b0)[1])
    log(f"fusion: {label} losses {losses} (fused and unfused steps in blocks "
        f"of {per_block}); batch 0 again {again}; global gradient norms "
        f"{[float(g) for g in grad_norms]}")
    if not all(np.isfinite(losses + [again])) or not again < loss_f:
        raise AssertionError(f"{label}: loss {loss_f} -> {again} on the "
                             f"repeated batch")
    tokens = b0.numel()
    row = {"fusion_train": label, "params": model.num_params(),
           "loss_step1_fused": loss_f, "loss_step1_unfused": loss_u,
           "loss_batch0_again": again,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "rewritten": fused.fusion_stats["rewritten"]}
    for name in runs:
        median = statistics.median(walls[name])
        fwd, bwd_ms, upd = (statistics.median(x[j] for x in split[name])
                            for j in range(3))
        row[name] = {"step_ms": median * 1e3,
                     "step_ms_each": [w * 1e3 for w in walls[name]],
                     "forward_ms": fwd, "backward_ms": bwd_ms,
                     "optimizer_ms": upd, "tokens_per_s": tokens / median,
                     "mfu": model.flops_per_token() * tokens / median
                     / BF16_FLOP_PER_S}
    log(json.dumps(row))
    if profile:
        for name, (forward, want_fwd) in runs.items():
            _profile(f"{label} {name} step",
                     lambda: _train_step(forward, opt, b0, want_fwd, bwd),
                     groups={"K1-K3 attention": ("flash_fwd", "dq_", "dkv_"),
                             "K4": ("residual_norm",),
                             "K6": ("gemm_wgmma", "norm_rows"),
                             "K7": ("gemm_rope_wgmma",),
                             "cuBLAS GEMM": ("nvjet", "xmma", "cutlass",
                                             "cublas"),
                             "elementwise and reductions": (
                                 "elementwise", "reduce", "vectorized")})


def _bias_act_program(gen):
    """to_static over gelu(x W + b) at x (8192, 1024), W (1024, 4096),
    bf16: the pass rewrites the add and the gelu onto fused_bias_act, which
    launches K5 once a call. Against the unfused program: two roundings
    (the unfused chain rounds the sum before the gelu)."""
    from paddle_tpu_torch import to_static
    from paddle_tpu_torch.nn import functional as F
    rows, k, n = 8192, 1024, 4096
    x = randn((rows, k), torch.bfloat16, gen)
    w = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).to(torch.bfloat16)
    b = (torch.randn((n,), generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)

    def program(xa):
        return F.gelu(torch.matmul(xa, w) + b)

    fused = to_static(program)
    fused(x)                                    # the first call traces
    before = _counts()
    out = fused(x)
    got = _launched(before, _counts())
    ref = program(x)
    diff = (out.float() - ref.float()).abs()
    ratio = (diff / (2 * FUSED_REL[torch.bfloat16] * ref.float().abs()
                     + FUSED_ABS)).max().item()
    fused_ms, _, _ = time_ms(lambda: fused(x), reps=KERNEL_REPS)
    unfused_ms, _, _ = time_ms(lambda: program(x), reps=KERNEL_REPS)
    log(json.dumps({"fusion_program": "gelu(x W + b) bf16 8192x1024->4096",
                    "rewritten": fused.fusion_stats["rewritten"],
                    "launches_a_call": got, "max_abs_diff": diff.max().item(),
                    "limit_ratio": ratio, "fused_ms": fused_ms,
                    "unfused_ms": unfused_ms}))
    if got != {"fused_bias_act": 1} or ratio > 1.0:
        raise AssertionError(f"bias_act program: launches {got}, "
                             f"{ratio:.3f} of the limit")


def phase_fusion(state):
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaConfig,
                                         LlamaForCausalLM, gpt2_medium,
                                         gpt2_small)
    set_flags({"FLAGS_enable_fusion": True})
    try:
        rng = np.random.RandomState(21)
        ids = torch.from_numpy(rng.randint(0, 32000, (1, 256)))
        _fused_forward_parity(
            "gpt2_small", lambda dev: GPTForCausalLM(gpt2_small(), device=dev,
                                                     seed=8), ids,
            {"flash_attention_fwd": 12, "fused_residual_norm": 24,
             "fused_matmul": 13})
        small = LlamaConfig(vocab_size=32000, hidden_size=1024,
                            intermediate_size=2816, num_layers=4,
                            num_heads=8, num_kv_heads=4, max_seq_len=512)
        _fused_forward_parity(
            "llama 4 layers, hidden 1024, 8 heads of 128, 4 kv heads",
            lambda dev: LlamaForCausalLM(small, device=dev, seed=9), ids,
            {"flash_attention_fwd": 4, "fused_residual_norm": 8,
             "fused_matmul_rope": 8})

        # path 1: LLaMA-770M, the JAX package's LLaMA training rung
        cfg = LlamaConfig(**LLAMA_770M)
        b, s = LLAMA_SHAPE["b"], LLAMA_SHAPE["s"]
        model = LlamaForCausalLM(cfg, device="cuda", dtype="bfloat16",
                                 seed=10).train()
        batches = [torch.from_numpy(np.random.RandomState(200 + i).randint(
            0, cfg.vocab_size, (b, s))).cuda() for i in range(2)]
        _fused_training(f"llama_770m bf16 AdamW(multi_precision) B{b} S{s}",
                        model, batches,
                        {"fused_residual_norm": 2 * cfg.num_layers,
                         "fused_matmul_rope": 2 * cfg.num_layers},
                        state.get("profile"))
        del model, batches
        torch.cuda.empty_cache()

        # path 2: GPT-2 345M at the train phase's batch
        cfg = gpt2_medium()
        b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
        model = GPTForCausalLM(cfg, device="cuda", dtype="bfloat16",
                               seed=11).train()
        batches = [torch.from_numpy(np.random.RandomState(300 + i).randint(
            0, cfg.vocab_size, (b, s))).cuda() for i in range(2)]
        _fused_training(f"gpt2_medium bf16 AdamW(multi_precision) B{b} S{s}",
                        model, batches,
                        {"fused_residual_norm": 2 * cfg.num_layers,
                         "fused_matmul": cfg.num_layers + 1},
                        state.get("profile"))
        del model, batches
        torch.cuda.empty_cache()

        # path 3: the bias_act program
        gen = torch.Generator(device="cuda")
        gen.manual_seed(99)
        _bias_act_program(gen)
    finally:
        set_flags({"FLAGS_enable_fusion": False})

# ------------------------------------------------------------------ rungs
# bench.py's training rungs run under amp O1 bf16 (bench.py:92)
O1 = dict(level="O1", dtype="bfloat16")
O2_FP16 = dict(level="O2", dtype="float16")
LLAMA_1_3B = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                  num_layers=24, num_heads=16, max_seq_len=2048)  # bench.py:412
# int8 moments against fp32 ones: 1 byte a value and a 4-byte scale every
# 256 values (1 + 4/256 bytes) over 4 bytes, with room for the padding of
# each tensor to whole blocks
INT8_STATE_RATIO = 0.27


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _state_bytes(opt):
    """(moments, fp32 masters) bytes of an optimizer's state; an int8
    moment counts its codes and its scales."""
    def nbytes(v):
        if isinstance(v, dict):
            return sum(nbytes(t) for t in v.values())
        return v.numel() * v.element_size()
    moments = sum(nbytes(v) for st in opt._accumulators.values()
                  for v in st.values())
    return moments, sum(nbytes(v) for v in opt._master_weights.values())


def _rung_adamw(model, **kw):
    """bench.py's AdamW on fp32 masters of bf16 resident weights."""
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=LR, parameters=model.named_parameters(),
                 multi_precision=True, **ADAMW, **kw)


def _rung_batches(vocab, b, s, seed):
    return [torch.from_numpy(np.random.RandomState(seed + i).randint(
        0, vocab, (b, s))).cuda() for i in range(2)]


def _run_rung(label, model, opt, batches, runs, steps, switches, card,
              amp_kw=O1, scaler=None, blocks=1, profile=False):
    """Train ``model`` with each of ``runs`` (name -> (forward, launches a
    forward, launches a backward)) in turn, ``steps`` steps a block, on
    the two ``batches`` taken in turn, under ``amp.auto_cast(**amp_kw)``.
    Every step's launches are held (``_train_step``); the losses must be
    finite and the loss on batch 0 again below the first. Returns the
    rung's row: step times (the first step of each block warms its path
    up and is not timed), the split by CUDA events, tokens/s, MFU, the
    peak memory, the optimizer state's bytes, the losses and the
    launches."""
    from paddle_tpu_torch import amp
    walls = {name: [] for name in runs}
    split = {name: [] for name in runs}
    losses = []
    steps_before = opt._step_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = _counts()
    for _ in range(blocks):
        for name, (forward, want_fwd, want_bwd) in runs.items():
            for k in range(steps):
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(4)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = _train_step(forward, opt, batches[len(losses) % 2],
                                   want_fwd, want_bwd, events,
                                   amp_kw=amp_kw, scaler=scaler)
                torch.cuda.synchronize()
                if k:
                    walls[name].append(time.perf_counter() - t0)
                    split[name].append([events[j].elapsed_time(events[j + 1])
                                        for j in range(3)])
                losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    launched = _launched(c0, _counts())
    first = next(iter(runs.values()))[0]
    b0 = batches[0]
    with torch.no_grad(), amp.auto_cast(**amp_kw):
        again = float(first(b0, labels=b0)[1])
    log(f"rungs: {label} losses {losses}; batch 0 again {again}")
    if not all(np.isfinite(losses + [again])) or not again < losses[0]:
        raise AssertionError(f"{label}: loss {losses[0]} -> {again} on the "
                             f"repeated batch")
    moments, masters = _state_bytes(opt)
    tokens = b0.numel()
    row = {"rung": label, "card": card, "params": model.num_params(),
           "switches": switches, "steps": len(losses),
           "optimizer_steps_taken": opt._step_count - steps_before,
           "flops_per_token": model.flops_per_token(),
           "peak_memory_gb": peak, "moment_bytes": moments,
           "master_bytes": masters, "loss_first": losses[0],
           "loss_last": losses[-1], "loss_batch0_again": again,
           "launches": launched}
    for name, (forward, want_fwd, want_bwd) in runs.items():
        q1, median, q3 = statistics.quantiles(walls[name], n=4)
        fwd, bwd, upd = (statistics.median(x[j] for x in split[name])
                         for j in range(3))
        row[name] = {"step_ms": median * 1e3, "step_ms_q1": q1 * 1e3,
                     "step_ms_q3": q3 * 1e3, "forward_ms": fwd,
                     "backward_ms": bwd, "optimizer_ms": upd,
                     "tokens_per_s": tokens / median,
                     "mfu": model.flops_per_token() * tokens / median
                     / BF16_FLOP_PER_S}
        if profile:
            prof = _profile(
                f"{label} {name} step",
                lambda: _train_step(forward, opt, b0, want_fwd, want_bwd,
                                    amp_kw=amp_kw, scaler=scaler),
                groups={"K1-K3 attention": ("flash_fwd", "dq_", "dkv_"),
                        "K4": ("residual_norm",), "K7": ("gemm_rope_wgmma",),
                        "cuBLAS GEMM": ("nvjet", "xmma", "cutlass",
                                        "cublas"),
                        "elementwise and reductions": (
                            "elementwise", "reduce", "vectorized")})
            row[name]["profiled_device_ms"] = prof["device_busy_s"] * 1e3
    return row


def _peak_of_step(model, opt, ids, want_fwd, want_bwd, **changes):
    """The peak memory (GB) of one eager O1 step with the model's
    configuration changed by ``changes`` for that step."""
    saved = {k: getattr(model.cfg, k) for k in changes}
    for k, v in changes.items():
        setattr(model.cfg, k, v)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _train_step(model, opt, ids, want_fwd, want_bwd, amp_kw=O1)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 1e9
    finally:
        for k, v in saved.items():
            setattr(model.cfg, k, v)


def _recompute_launches(layers, fused_fwd=None):
    """A step's launches with block recompute: (forward, backward). The
    backward replays each block's forward, so it launches K1 (and a fused
    forward's K4/K7) again, beside K2 and K3."""
    fwd = dict({"flash_attention_fwd": layers}, **(fused_fwd or {}))
    bwd = dict(fwd, flash_attention_bwd_dq=layers,
               flash_attention_bwd_dkv=layers)
    return fwd, bwd


def _rung_gpt(card, profile):
    """GPT-2 345M (bench.py _bench_gpt): O1 bf16, fused loss, 10 steps;
    its peak against one step of the plain loss. The weights and batches
    are the ``train`` phase's (seeds 5 and 100): the same program there
    with the rung's switches on. (From seed 12 the loss spikes after step
    10 with or without amp and the fused loss alike, this optimizer's
    dynamics on two repeated batches: tools/torch_train_trajectory.py.)"""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_medium
    cfg = gpt2_medium(fused_loss=True)
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    model = GPTForCausalLM(cfg, device="cuda", dtype="bfloat16",
                           seed=5).train()
    opt = _rung_adamw(model)
    batches = _rung_batches(cfg.vocab_size, b, s, 100)
    fwd, bwd = _flash_launches(cfg.num_layers)
    row = _run_rung(f"gpt2_medium O1 bf16 fused_loss B{b} S{s}", model, opt,
                    batches, {"eager": (model, fwd, bwd)}, 10,
                    dict(amp="O1 bfloat16", fused_loss=True, recompute=False,
                         moment_dtype=None, fusion=False), card,
                    profile=profile)
    row["peak_memory_gb_plain_loss_step"] = _peak_of_step(
        model, opt, batches[0], fwd, bwd, fused_loss=False)
    log(json.dumps(row))
    if not row["peak_memory_gb"] < row["peak_memory_gb_plain_loss_step"]:
        raise AssertionError(f"345M: the fused loss's peak "
                             f"{row['peak_memory_gb']} GB is not below the "
                             f"plain loss's "
                             f"{row['peak_memory_gb_plain_loss_step']} GB")


def _rung_llama_770m(card, profile):
    """LLaMA-770M (bench.py _bench_llama): O1 bf16, recompute, fused loss;
    8 steps through to_static with fusion and 8 eager, in blocks of 4; the
    fused and eager step-1 losses agree; its peak against one step
    without recompute."""
    from paddle_tpu_torch import amp, set_flags, to_static
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(**LLAMA_770M, recompute=True, fused_loss=True)
    b, s, layers = LLAMA_SHAPE["b"], LLAMA_SHAPE["s"], cfg.num_layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype="bfloat16",
                             seed=13).train()
    opt = _rung_adamw(model)
    batches = _rung_batches(cfg.vocab_size, b, s, 500)
    b0 = batches[0]
    set_flags({"FLAGS_enable_fusion": True})
    try:
        fused = to_static(model)
        with torch.no_grad(), amp.auto_cast(**O1):
            loss_u = float(model(b0, labels=b0)[1])
            loss_f = float(fused(b0, labels=b0)[1])       # traces
        log(f"rungs: llama_770m step-1 loss fused {loss_f} eager {loss_u} "
            f"(tolerance {FUSED_LOSS_TOL}); fusion_stats "
            f"{fused.fusion_stats}")
        if not abs(loss_f - loss_u) <= FUSED_LOSS_TOL:
            raise AssertionError(f"llama_770m: fused step-1 loss {loss_f} "
                                 f"against eager {loss_u}")
        runs = {"fused": (fused, *_recompute_launches(
                    layers, {"fused_residual_norm": layers,
                             "fused_matmul_rope": 2 * layers})),
                "eager": (model, *_recompute_launches(layers))}
        row = _run_rung(f"llama_770m O1 bf16 recompute fused_loss B{b} S{s}",
                        model, opt, batches, runs, 4,
                        dict(amp="O1 bfloat16", fused_loss=True,
                             recompute=True, moment_dtype=None,
                             fusion="fused run: to_static with "
                                    "FLAGS_enable_fusion"),
                        card, blocks=2, profile=profile)
    finally:
        set_flags({"FLAGS_enable_fusion": False})
    row["loss_step1_fused"], row["loss_step1_eager"] = loss_f, loss_u
    row["rewritten"] = fused.fusion_stats["rewritten"]
    row["peak_memory_gb_no_recompute_step"] = _peak_of_step(
        model, opt, b0, *_flash_launches(layers), recompute=False)
    log(json.dumps(row))
    if not row["peak_memory_gb"] < row["peak_memory_gb_no_recompute_step"]:
        raise AssertionError(f"llama_770m: the peak with recompute "
                             f"{row['peak_memory_gb']} GB is not below one "
                             f"step's without it "
                             f"{row['peak_memory_gb_no_recompute_step']} GB")


def _rung_llama_1_3b(card, profile):
    """LLaMA-1.3B (bench.py _bench_llama14): O1 bf16, recompute, fused
    loss, int8 Adam moments, 4 steps; the int8 state at most
    INT8_STATE_RATIO of fp32 moments'."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(**LLAMA_1_3B, recompute=True, fused_loss=True)
    b, s = 2, 2048
    model = LlamaForCausalLM(cfg, device="cuda", dtype="bfloat16",
                             seed=14).train()
    opt = _rung_adamw(model, moment_dtype="int8")
    batches = _rung_batches(cfg.vocab_size, b, s, 600)
    row = _run_rung(f"llama_1.3b O1 bf16 recompute fused_loss int8 moments "
                    f"B{b} S{s}", model, opt, batches,
                    {"eager": (model, *_recompute_launches(cfg.num_layers))},
                    4, dict(amp="O1 bfloat16", fused_loss=True,
                            recompute=True, moment_dtype="int8",
                            fusion=False), card, profile=profile)
    fp32_moments = 2 * 4 * model.num_params()
    row["moment_bytes_over_fp32"] = row["moment_bytes"] / fp32_moments
    log(json.dumps(row))
    if not row["moment_bytes_over_fp32"] <= INT8_STATE_RATIO:
        raise AssertionError(f"1.3B: int8 moments take "
                             f"{row['moment_bytes_over_fp32']:.4f} of fp32's")


def _rung_gpt_fp16(card, profile):
    """GPT-2 345M fp16 O2: decorate and a GradScaler from 2^16, 10 steps;
    then one step with an inf planted in a gradient, which is skipped:
    the scale halves and the weights, masters and moments stay bitwise."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_medium
    cfg = gpt2_medium(fused_loss=True)
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    model = GPTForCausalLM(cfg, device="cuda", seed=15).train()
    opt = _rung_adamw(model)
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=65536.0)
    batches = _rung_batches(cfg.vocab_size, b, s, 700)
    fwd, bwd = _flash_launches(cfg.num_layers)
    row = _run_rung(f"gpt2_medium O2 fp16 GradScaler fused_loss B{b} S{s}",
                    model, opt, batches, {"eager": (model, fwd, bwd)}, 10,
                    dict(amp="O2 float16 (decorate, GradScaler)",
                         fused_loss=True, recompute=False, moment_dtype=None,
                         fusion=False), card, amp_kw=O2_FP16, scaler=scaler,
                    profile=profile)
    # the overflow step
    scale = scaler._scale
    with amp.auto_cast(**O2_FP16):
        _, loss = model(batches[0], labels=batches[0])
    scaler.scale(loss).backward()
    model.gpt.blocks[0].mlp.fc1.weight.grad[0, 0] = float("inf")
    weights = [p.detach().clone() for p in model.parameters()]
    masters = {n: v.clone() for n, v in opt._master_weights.items()}
    moments = {n: {k: v.clone() for k, v in st.items()}
               for n, st in opt._accumulators.items()}
    scaler.step(opt)
    opt.clear_grad()
    unchanged = (all(torch.equal(a, p) for a, p in
                     zip(weights, model.parameters()))
                 and all(torch.equal(v, opt._master_weights[n])
                         for n, v in masters.items())
                 and all(torch.equal(v, opt._accumulators[n][k])
                         for n, st in moments.items() for k, v in st.items()))
    row.update(scale_before_overflow=scale, scale_after_overflow=scaler._scale,
               overflow_step_left_state_bitwise=unchanged)
    log(json.dumps(row))
    if not (unchanged and scaler._scale == scale / 2):
        raise AssertionError(f"fp16 overflow step: scale {scale} -> "
                             f"{scaler._scale}, state unchanged {unchanged}")


def phase_rungs(state):
    card = _card_line()
    for rung in (_rung_gpt, _rung_llama_770m, _rung_llama_1_3b,
                 _rung_gpt_fp16):
        rung(card, state.get("profile"))
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler breakdowns of a "
                        "bf16 forward, engine run and training step, of a "
                        "fused and an unfused step of each fusion path, "
                        "and of one step of each rung")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    state = {"profile": args.profile}
    launches = dict.fromkeys(KERNELS, 0)     # over the main path
    for phase in PHASES:
        if phase not in phases:
            continue
        main_path = phase in MAIN_PATH
        if main_path:                          # each main-path phase starts
            for name in KERNELS:
                _wrapper(name).launches = 0
        log(f"== {phase}")
        globals()[f"phase_{phase}"](state)
        if main_path:                          # ... and is read as it ends
            for name, n in _counts().items():
                launches[name] += n
    if phases != list(PHASES):
        return 0
    never = [name for name, n in launches.items() if n == 0]
    if never:
        raise AssertionError(f"the main path never launched {never}")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        k = state["kernels"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/{replaces}",
            "launches": launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "shape": k["shape"],
            "timing": f"median of CUDA-event pairs, each around "
                      f"{KERNEL_REPS} back-to-back launches queued behind "
                      f"a sleep kernel"})
        if "shapes" in k:          # K2/K3: every path shape, this one first
            rows[-1]["shapes"] = k["shapes"]
    log(json.dumps({"kernels": rows}))
    log(_card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
