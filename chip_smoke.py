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
* paddle_api -- the Paddle API's eager core (``import paddle_tpu_torch as
             paddle``): bench.py's _bench_dispatch (300 128x128 fp32
             ``paddle.matmul``s with grad, under no_grad, and raw
             ``torch.matmul``: us an op); a tiny fp32 BERT (bench.py's
             small config with 2 heads of 64: K1-K3 take head dims 64 and
             128) on the card against a CPU twin with the same weights,
             logits within LOGITS_TOL and three AdamW steps' losses
             within LOSS_TOL, K1/K2/K3 once a layer a step; K1-K3 at
             BERT-base's attention (B48 S512 H12 d64, non-causal, bf16)
             against their plain versions, two K2/K3 calls bitwise equal,
             timed beside bound and SDPA (rows under each kernel's
             "shapes"); then bench.py's BERT-base rung (_bench_bert:
             vocab 30592, 12 layers, B=48, S=512, the fused loss, bf16
             weights, fp32 masters, AdamW, O1), 10 timed steps after 2 of
             warm-up, one JSON line like the rungs'.
* perf    -- performance attribution (observability.perf, profiler,
             tools.perf_report) on bench.py's BERT-base rung (paddle_api's
             settings: B48 S512, O1, bf16 weights, fp32 masters, AdamW,
             eager): the step with every new flag off (the cost of turning
             them on, beside paddle_api's step and the step with
             FLAGS_perf_op_cost on; not gated); a per-op pass
             (FLAGS_enable_metrics, FLAGS_perf_op_cost, FLAGS_benchmark;
             PERF_STEPS steps) whose perf_report rows (top 10 logged) give
             the attention op as many calls as K1 launched, no row above
             PERF_ROOF % of its roofline, and modeled forward FLOPs within
             PERF_FLOPS_TOL of FlopCounterMode over one forward; the step
             attribution (compute + collective + host + idle within
             PERF_SUM_TOL of each step); the memory census at a step's high
             water (params, grads and optimizer_state equal to the bytes of
             the parameters, their gradients and the moments and masters,
             exactly; the claimed bytes at most memory_allocated, the high
             water at most max_memory_allocated); paddle.profiler with the
             CPU and GPU targets over 5 steps (closed 1, ready 1, record 3)
             and RecordEvent forward/backward/optimizer: the attention op
             and K1 36 times over the window, the device trace (torch.
             profiler) naming K1's, K2's and K3's kernels 36 times each, the
             host file 3 forward ranges; a to_static bf16 forward under
             FLAGS_perf_capture (one record, FLOPs within PERF_FLOPS_TOL of
             FlopCounterMode over the eager forward, peak_bytes > 0). Every
             kernel row (kernel, fused_kernel, paddle_api, paddle_static,
             distributed) also holds the cost model's roofline bound of its
             shapes (model_bound_ms) within MODEL_BOUND_TOL of its own; the
             serve_llama phase holds the census's kv_cache to its plain bf16
             engine's pages (0 once dropped); the sot phase keeps its
             segment plans' analyses (FLAGS_perf_capture, "sot").
* paddle_static -- ``to_static`` over Paddle-API Layers (the dispatcher's
             recorder; a signature's first call records, the next replay):
             the tiny fp32 BERT fused, a recording step and three replayed
             AdamW steps on the card against a CPU twin (losses within
             LOSS_TOL, the pass's stats equal, K4 and K6 launched as the
             pass predicts); bench.py's fusion block (_bench_fusion) at
             full size in its Paddle-API spelling (B8 S512 H1024 FF4096,
             16 heads, fp32 as bench.py builds it): the train leg
             (to_static(full_graph=True), (out*out).mean() and its
             backward) fused against unfused, the eager leg unfused
             against the F.fused_* spelling, in interleaved chunks (the
             min of the chunk means), bench.py's two parity gates and the
             rewrites {rope_proj: 2, norm_linear: 1, residual_norm: 1},
             both ratios printed; bench.py's BERT-base rung (paddle_api's
             settings) eager, to_static unfused, to_static fused (rewritten
             {residual_norm: 24, linear_act: 13}; a step launches K4 24,
             K6 13, K1/K2/K3 12) and fused with recompute=True, one JSON
             line each and one comparing them (fused against unfused first
             replayed loss within FUSED_LOSS_TOL, recompute against fused
             within BF16_TOL); then K4 and K6 at the fused BERT step's
             shapes against their plain versions and timed (rows under
             each kernel's "shapes"), with the copy that hands K6 a
             Paddle (in, out) weight.
* sot     -- SOT partial-frame capture: bench.py's BERT-base rung
             (paddle_api's settings) whose forward reads
             isfinite(seq).all() on the host between the encoder and the
             heads, under to_static(full_graph=False): two segments a
             call. (a) Trained eager, under SOT and under SOT with
             FLAGS_enable_fusion (SOT_WARMUP + SOT_STEPS steps each): step
             ms and quartiles, host ms, tokens/s, sot_stats and peak GB;
             a step launches K1/K2/K3 12 (the first SOT step K1 24: the
             recording runs the encoder before the break) and, fused, K4
             24 and K6 13; the first replayed losses against eager
             (BF16_TOL unfused, FUSED_LOSS_TOL fused); compiled 0 from the
             second step. (b) Served in eval, frozen bf16 weights, B48
             S512, unfused and fused: calls 1-2 replay and call 3
             bypasses, each within BF16_TOL (norm-wise) of eager and
             launching K1 12 (K4 24, K6 13 fused); eager, replay and
             bypass timed in turns; then one weight changed with
             set_value: the next call still bypasses and answers as eager.
* checkpoint -- checkpoints and resume: bench.py's BERT-base rung
             (paddle_api's settings, with a StepDecay scheduler that
             keeps LR over the phase) trained 8 steps twice from one seed
             (are the runs bitwise equal?); a third run saves its train
             state (about 1.5 GB) through CheckpointManager(keep_n=2) at
             steps 2 and 4 and is cut; a fresh model from another seed
             auto_resumes it (every parameter, master, moment,
             @step_count and scheduler field bitwise equal to a host copy
             of the step-4 state, every moment restored) and retrains
             steps 5-8 (losses bitwise equal to the uninterrupted run's,
             or within the two runs' spread when they differ); save and
             load seconds and GB/s with and without verify, the save's
             host copy, CRC and write+fsync timed apart; a byte flipped in
             the newest file (restore falls back to step 2, depth 1, one
             warning), a truncated copy (CheckpointCorruptError naming
             the section); the MTTR drill (bench.py's
             _bench_fault_recovery): a child saves and SIGKILLs itself, a
             relaunched one auto_resumes, split into process start and
             imports, CUDA context, model build, and load with
             verification; then hapi at full width: ResNet-50 Model.fit
             (vision's fit settings, fp32) with ModelCheckpoint(manager,
             save_steps=2) and a save_dir, cut after epoch 0, a fresh
             Model's fit(resume=manager) (step, @step_count, moments and
             weights equal to the saved ones right after the restore),
             Model.save/load bitwise, summary's and flops' counts equal
             to the JAX package's. One JSON line a part, with the card.
             Written under a tempfile.mkdtemp() directory (its free space
             printed first, at least three checkpoints), deleted after.
* vision  -- image classification in the Paddle API: a tiny fp32
             ResNet-18 (bench.py's small ResNet size: 10 classes, B=4,
             64x64) on the card against a CPU twin with the same weights,
             TF32 off (logits within LOGITS_TOL, each parameter's gradient
             norm-wise within RESNET_GRAD_TOL, three AdamW steps' losses
             (at RESNET_PARITY_LR) and the running statistics after them
             within LOSS_TOL); then
             bench.py's ResNet-50 rung (_bench_resnet50: B=256, 224x224,
             1000 classes, fp32 live weights, bench.py's AdamW, O1 bf16,
             RandomState(i) batches made before timing, 2 warm-up and 10
             timed steps), one JSON line in the rung format (images/s,
             MFU from 3 x 4.1 GFLOP an image, vs_baseline against the
             A100's 2080 images/s, step ms and quartiles, the CUDA-event
             split, peak memory, the losses, the card), the losses finite
             and the first timed batch's loss again below its first,
             peak memory below the card's; then hapi
             Model.fit on ResNet-50 at full width in fp32: 256 seeded
             images, batch 64, 2 epochs, shuffled, 2 forked workers,
             prefetch on, Accuracy(topk=(1, 5)), EarlyStopping and
             LRScheduler, then evaluate and predict (finite history, the
             goodput ledger's 8 steps, every batch on the card through
             the prefetcher, no worker left, predict (256, 1000)), fit's
             images/s beside the rung's.
* deploy  -- deployment: a BERT-base sequence classifier at bench.py's
             _bench_bert widths (vocab 30522, 12 layers, 12 heads of 64,
             FF 3072, 512 positions, 2 classes; seeded weights, eval, no
             dropout) saved with jit.save (InputSpec([-1, -1], "int64")
             for ids and token types) in fp32 and in bf16, and in fp32
             from a CPU twin with the same weights; each artifact served
             through inference.Config / create_predictor at (B, S) in
             {1, 8, 48} x {128, 512}: exactly 12 K1 launches a run and
             none of K2/K3; K1 against its plain version at that
             attention shape in fp32 and bf16 (FP32_TOL, BF16_TOL); the
             logits within FP32_TOL (bf16: BF16_TOL) of the eager model
             (a check of the export: both launch the same K1), then timed
             in five interleaved rounds (Predictor.run p50 of 20 with its
             host copies, the TranslatedLayer on device tensors, the
             eager forward under no_grad, each with its quartiles;
             sequences/s; resident and peak memory); the fp32 artifact under disable_gpu() against the
             card (LOGITS_TOL, B1 S128); the CPU-saved artifact on the
             card (K1 12 a run, FP32_TOL of the card-saved one); a fresh
             process (relaunched as the checkpoint phase relaunches its
             child) that loads through paddle_tpu_torch.inference alone,
             its logits within FP32_TOL and its seconds split; PTQ of
             BERT-base saved, reloaded and run (FP32_TOL of the quantized
             eager model, .pdparams under 0.45x of fp32's, argmax
             agreement with fp32); onnx.export of ResNet-50 (224x224,
             B=1, fp32) from card tensors, the bundled numpy runtime
             within LOGITS_TOL of the card. Save and load seconds split
             (export and write; state and program). One JSON line a part,
             with the card. Written under a tempfile.mkdtemp() directory,
             deleted after.

* static_program -- BERT-base (BERT_BASE) served from a static.Program
             built under program_guard over static.data: (a) fp32 at B2
             S128, Executor.run on the card unfused and fused against the
             same program on a CPU twin (FP32_TOL), fused against unfused
             (LOGITS_TOL), the pass's stats as predicted; (b) bf16 at B48
             S512: Executor.run unfused and fused against the eager
             forward (norm-wise BF16_TOL), K1 12 a run and with fusion K4
             and K6 as fusion_stats says (24 and 12), then timed in turns
             beside the eager forward, with the host ms and the ops
             replayed a run (one JSON line); (c) the unfused program
             through save_inference_model, load_inference_model and
             inference.create_predictor: both outputs within BF16_TOL of
             (b)'s run, K1 12 a run, the seconds and ms (one JSON line);
             (d) LeNet from static.nn over [None, 1, 28, 28] at B256 and
             B100 from one program against a CPU twin (FP32_TOL), a
             py_func in a card program, an EMA's apply and restore.
* distributed -- paddle_tpu_torch.distributed on NCCL: prints ``nvidia-smi
             topo -m``, the NCCL version and the card, builds the flash
             kernels once, then runs one rank a card
             (torch.cuda.device_count()) through the port's launcher
             (python -m paddle_tpu_torch.distributed.launch; each rank is
             this script with --dist-rank). Each rank: every collective
             on the world and on each axis group of a dp x mp mesh (mp 2
             on an even world), fp32 and bf16 on integer-valued data,
             exactly equal to the host's result; all_reduce's bus
             bandwidth at 256 MB; K1-K3 on its own card against their
             plain versions at GPT-2 345M's attention under dp2 x mp2
             (B4 S1024 H8 d64, bf16, q/k/v views), at the padded head
             dims 32 and 96 (fp32, bf16) and at the tiny GPT's shapes of
             the parity run below (S16 d16, its batch rows and heads a
             rank, fp32 causal views), then timed at the TP shape
             beside bound and SDPA. Then the main path: the tiny fp32
             GPT of the JAX TestDistBase (d=16, padded) trained 6 AdamW
             steps at dp N, dp N/2 x mp 2 and dp N/2 x sharding 2, the
             mean loss over the ranks within 2e-4 of every rank's own
             one-card run of the same batch and weights; GPT-2 345M
             (bf16 weights, fp32 masters, O1, S1024) alone on each card
             at B8, at dp N with B8 a card (DataParallel's reducer) and
             at dp N/2 x mp 2 at a global batch of 8 (bench.py
             _bench_spmd_auto's fleet leg), 2 + 10 steps: one JSON line
             each (step ms and quartiles, global tokens/s, MFU a card,
             peak GB, launches, reducer buckets, scaling efficiency
             against N times the one-card rate). On one card the world is
             1 and the strategies that need more cards are named. Every
             step of the ranks launches K1 once a layer forward and K2
             and K3 once a layer backward; their launches are the
             phase's. Every rank records its collectives
             (PADDLE_TPU_FLIGHT_RECORD) and dumps them at the end; rank
             0's diff_ranks over the world must say in sync, each group's
             last sequence number equal. With two cards or more, the
             desync drill: a short launch of the tiny GPT at dp N whose
             last rank skips one all_reduce (collective.desync), a
             Watchdog(timeout=DRILL_TIMEOUT, abort_on_hang=True) on every
             rank; the waiting ranks' verdicts name the last rank and the
             skipped sequence number, and the launch ends with
             EXIT_DESYNC (119); with one card it logs that it did not
             run. Gloo never runs here; a failed rank fails the phase.
* seq2seq -- Transformer-base (Vaswani et al. 2017, "base") on the port's
             nn.Transformer at its published widths (d 512, 8 heads, 6 + 6
             layers, FF 2048, a shared 37,000-token embedding, sinusoidal
             positions): 3 fp32 steps (B4 S32, dropout 0, Adam under
             NoamDecay, label smoothing 0.1) on the card against a CPU twin,
             the losses within LOSS_TOL and the first step's gradients
             (through K2/K3) each within SEQ2SEQ_GRAD_TOL; 10 timed bf16 O1
             steps at B32 S128+128, dropout 0.1 (step ms and its split,
             tokens/s, MFU, peak GB); a greedy decode of 32 sources, 128
             tokens, through gen_cache and the attention caches, K1 at every
             attention (6 + 12 launches a token), the ids equal to a full
             recompute where the top-two gap exceeds TOP2_GAP and the first
             steps' logits within LOGITS_TOL of the CPU; then the bf16
             decode, timed.

The forward, serve, serve_llama, serve_tier, train, fusion, rungs,
paddle_api, perf, paddle_static, sot, checkpoint, vision, vision_zoo,
deploy, distributed and seq2seq phases are the main path (serve_tier and vision
launch no kernel: the tier is host code over the engine, and its LLaMA
runs without flash attention, as bench.py's rungs do; ResNet's
convolutions and pools are cuDNN's and torch's, as the JAX package's are
XLA's, not Pallas kernels): every kernel's launch count is set to
0 just before each of them and read just after it. The last lines are the kernels' JSON summary
(all seven, with their launches over the main path), the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}.
``--profile`` adds a torch.profiler breakdown of a bf16 forward, a GPT-2
and a LLaMA engine run, one training step, a fused and an unfused step of
each fusion path, one step of each rung, one BERT-base step (and one of
each of paddle_static's four BERT-base runs), one ResNet-50 rung step,
one Predictor.run of each deployed BERT-base at B48 S512 and, on rank 0,
one GPT-2 345M step of each distributed run (alone, dp, dp x mp).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

from paddle_tpu_torch.observability import perf as _perf

PHASES = ("build", "kernel", "fused_kernel", "forward", "serve",
          "serve_llama", "serve_tier", "train", "fusion", "rungs",
          "paddle_api", "perf", "paddle_static", "sot", "checkpoint",
          "vision", "vision_zoo", "deploy", "static_program", "distributed",
          "seq2seq", "control_flow", "ops")
MAIN_PATH = ("forward", "serve", "serve_llama", "serve_tier", "train",
             "fusion", "rungs", "paddle_api", "perf", "paddle_static", "sot",
             "checkpoint",
             "vision", "vision_zoo", "deploy", "static_program",
             "distributed", "seq2seq", "control_flow", "ops")
PATH_SHAPE = dict(b=4, s=1024, h=12, d=64)      # GPT-2 small serving
TRAIN_SHAPE = dict(b=8, s=1024, h=16, d=64)     # GPT-2 345M training
LLAMA_ATTN_SHAPE = dict(b=4, s=2048, h=12, d=128)   # LLaMA-770M fusion path
DECODE_ATTN = (32, 8, 64)       # Transformer-base decode: B, H, d
DECODE_KEYS = (1, 7, 63, 64, 65, 128)
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
# published dense peaks of one H100 SXM, from observability.perf's
# datasheet tables (the port's roofline reads the same numbers)
_H100_SXM = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = _perf.PEAK_HBM_BW[_H100_SXM]
BF16_FLOP_PER_S = _perf.PEAK_FLOPS[_H100_SXM]
FP32_FLOP_PER_S = 67e12     # CUDA cores, for the elementwise kernels
# a kernel row's modeled bound (the cost model's roofline on the row's
# shapes) against its own bound: a gap above this is a wrong formula
MODEL_BOUND_TOL = 0.05


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
    # the seq2seq decode's shapes (B32 H8 d64): one query row against a
    # growing self-attention cache, then cross-attention with s_q != s_k
    b, h, d = DECODE_ATTN
    cases += [(f"decode s_q=1 vs {s_k}", b, 1, s_k, h, d, False, False)
              for s_k in DECODE_KEYS]
    cases += [("decode s_q=1 vs 65 causal", b, 1, 65, h, d, True, False),
              ("cross s_q=128 vs 96", b, 128, 96, h, d, False, False),
              ("encoder S=128 non-causal", b, 128, 128, h, d, False,
               False)]
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
    # the seq2seq decode: one query row against 128 cached keys
    _time_fwd(fa, gen, dict(b=b, s=128, s_q=1, h=h, d=d), causal=False)
    _kernel_bwd(fa, gen, state)


def _bound(moved, flops, peak=BF16_FLOP_PER_S):
    """(bound ms, what bounds it) from bytes moved and FLOPs done at the
    ``peak`` rate of their type."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / peak * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def _model_bound(op, shapes, dtypes, attrs, outs, bound_ms):
    """The cost model's bound of one kernel row (``perf.costmodel``'s
    roofline of ``cost_of(op, shapes)`` at the datasheet peaks), held
    within MODEL_BOUND_TOL of the row's own ``bound_ms``."""
    cost = _perf.cost_of(op, shapes, dtypes, attrs, outs)
    ms = _perf.costmodel.roofline_bound(
        cost, BF16_FLOP_PER_S, HBM_BYTES_PER_S)["seconds"] * 1e3
    if not abs(ms / bound_ms - 1.0) <= MODEL_BOUND_TOL:
        raise AssertionError(
            f"the cost model's bound of {op} at {shapes} {attrs} is "
            f"{ms:.6f} ms, the row's {bound_ms:.6f} ms: a formula is wrong")
    return ms


def _mode(causal):
    return "causal" if causal else "non-causal"


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


def _time_fwd(fa, gen, shape, causal=True):
    """K1 at one path shape (bf16, causal unless told; ``s_q`` queries,
    ``s`` by default, against ``s`` keys): its time beside its bound, its
    plain version and PyTorch's SDPA; logs the row and returns the
    kernels-line fields."""
    b, s, h, d = shape["b"], shape["s"], shape["h"], shape["d"]
    s_q = shape.get("s_q", s)
    q, k, v = _qkv(b, s_q, s, h, d, torch.bfloat16, gen)
    def run():
        return fa.flash_attention_fwd(q, k, v, causal=causal)
    ms, q1, q3 = time_ms(run, reps=KERNEL_REPS, queued=True)
    counted = fa.flash_attention_fwd.launches   # host timing: not counted
    host = host_ms(run)
    fa.flash_attention_fwd.launches = counted
    plain_ms, _, _ = time_ms(
        lambda: fa.flash_attention_fwd_plain(q, k, v, causal=causal), iters=5,
        queued=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms, _, _ = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=KERNEL_REPS, queued=True)
    # q and out, k and v, and the fp32 LSE
    moved = 2 * b * (s_q + s) * h * d * q.element_size() + b * h * s_q * 4
    flops = 4.0 * b * h * d * _visible_pairs(s_q, s, causal)
    bound_ms, bound_by = _bound(moved, flops)
    model_ms = _model_bound(
        "flash_attention", [(b, s_q, h, d), (b, s, h, d), (b, s, h, d)],
        [torch.bfloat16] * 3, {"causal": causal}, [(b, s_q, h, d)],
        bound_ms)
    label = (f"B{b} S{s} H{h} d{d} bf16 {_mode(causal)}" if s_q == s else
             f"B{b} Sq{s_q} Sk{s} H{h} d{d} bf16 {_mode(causal)}")
    log(json.dumps({"kernel": "flash_attention_fwd", "shape": label,
                    "kernel_ms": ms, "kernel_ms_q1": q1, "kernel_ms_q3": q3,
                    "host_ms_a_call": host,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "model_bound_ms": model_ms,
                    "library_ms": library_ms, "plain_ms": plain_ms,
                    "bytes": moved, "flops": flops}))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, model_bound_ms=model_ms,
                library_ms=library_ms, shape=label, host_ms=host)


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
        # the seq2seq phase's fp32 steps: fewer keys than one key tile
        ("seq2seq parity", 4, 32, 32, 8, 64, False, False),
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


def _bwd_deterministic(fa, gen, shape=(2, 1000, 4, 128), causal=True):
    """Two calls of K2 and K3 on one input give bitwise-equal dq, dk and dv
    (no atomics: each sum runs in one order), in bf16; by default at a
    causal d=128 shape with ragged tiles."""
    b, s, h, d = shape
    q, k, v, do = _bwd_inputs(b, s, s, h, d, torch.bfloat16, gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.flash_attention_bwd_delta(out, do)
    runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal)) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"  bwd bfloat16 {shape} {_mode(causal)} two calls bitwise equal "
        f"(dq, dk, dv): {same}")
    if not all(same):
        raise AssertionError(f"K2/K3 differ from call to call: {same}")


def _time_bwd(fa, gen, shape, causal=True):
    """K2 and K3 at one path shape (bf16, causal unless told): each one's
    time beside its bound, the plain backward and PyTorch's flash backward
    (one call that computes dQ, dK and dV: one time for the pair), and the
    host time a call; logs one row each and returns the kernels-line
    fields."""
    b, s, h, d = shape["b"], shape["s"], shape["h"], shape["d"]
    q, k, v, do = _bwd_inputs(b, s, s, h, d, torch.bfloat16, gen)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.flash_attention_bwd_delta(out, do)
    calls = {
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal=causal),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal=causal)}
    times = {name: (time_ms(fn, reps=KERNEL_REPS, queued=True), host_ms(fn))
             for name, fn in calls.items()}
    plain_ms, _, _ = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal=causal), iters=5, queued=True)
    leaves, lib_out = _library_attention(q, k, v, causal)
    lib_do = do.transpose(1, 2).contiguous()
    library_ms, _, _ = time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, lib_do, retain_graph=True), reps=KERNEL_REPS,
        queued=True)
    tensor_bytes = b * s * h * d * q.element_size()
    row_bytes = b * h * s * 4                       # lse or Delta
    pairs = _visible_pairs(s, s, causal)
    plans = {
        # reads q, k, v, dO, lse, Delta; writes dQ. S, dP, dS K: 6d a pair
        "flash_attention_bwd_dq": (5 * tensor_bytes + 2 * row_bytes,
                                   6.0 * d * pairs * b * h),
        # reads the same; writes dK, dV. S, dP, P^T dO, dS^T Q: 8d a pair
        "flash_attention_bwd_dkv": (6 * tensor_bytes + 2 * row_bytes,
                                    8.0 * d * pairs * b * h),
    }
    label = f"B{b} S{s} H{h} d{d} bf16 {_mode(causal)}"
    fields = {}
    for name, (moved, flops) in plans.items():
        (ms, q1, q3), host = times[name]
        bound_ms, bound_by = _bound(moved, flops)
        model_ms = _model_bound(
            name, [(b, s, h, d)] * 4 + [(b, h, s)] * 2,
            [torch.bfloat16] * 4 + [torch.float32] * 2, {"causal": causal},
            (), bound_ms)
        log(json.dumps({"kernel": name, "shape": label,
                        "kernel_ms": ms, "kernel_ms_q1": q1,
                        "kernel_ms_q3": q3, "host_ms_a_call": host,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "model_bound_ms": model_ms,
                        "library_ms_dq_dk_dv": library_ms,
                        "plain_ms_dq_dk_dv": plain_ms, "bytes": moved,
                        "flops": flops}))
        fields[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, model_bound_ms=model_ms,
                            library_ms=library_ms, shape=label)
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
                peak=BF16_FLOP_PER_S, model=None):
    """One K4-K7 timing at its path shape: the kernel (ten launches back to
    back a CUDA-event pair, queued), its plain version and a PyTorch
    yardstick; ``model``: the registry op and its (shapes, dtypes, attrs,
    output shapes) in the Paddle layouts, for the row's modeled bound."""
    ms, q1, q3 = time_ms(run, reps=KERNEL_REPS, queued=True)
    host = host_ms(run)
    plain_ms, _, _ = time_ms(plain, iters=5, queued=True)
    library_ms, _, _ = time_ms(library, reps=KERNEL_REPS, queued=True)
    bound_ms, bound_by = _bound(moved, flops, peak)
    model_ms = _model_bound(*model, bound_ms)
    log(json.dumps({"kernel": name, "shape": label, "kernel_ms": ms,
                    "kernel_ms_q1": q1, "kernel_ms_q3": q3,
                    "host_ms_a_call": host,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "model_bound_ms": model_ms,
                    "library_ms": library_ms, "library_call": library_call,
                    "plain_ms": plain_ms, "bytes": moved, "flops": flops}))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, model_bound_ms=model_ms,
                library_ms=library_ms, shape=label)


def _fused_model(op, shapes, outs, dtype=torch.bfloat16):
    """A K4-K7 row's cost-model op (``_time_fused``'s ``model``): the
    registry op, its input shapes in the Paddle layouts (weights (in,
    out)), one dtype and its output shapes."""
    return op, shapes, [dtype] * len(shapes), {}, outs


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
        4 * rows * h * 2 + h * 2, 8.0 * rows * h, FP32_FLOP_PER_S,
        _fused_model("fused_residual_norm", [(rows, h)] * 2 + [(h,)],
                     [(rows, h)] * 2))}
    xg, resg, wg, bg = r(rows, d_gpt), r(rows, d_gpt), 1 + r(d_gpt), r(d_gpt)
    _time_fused("fused_residual_norm", f"{rows}x{d_gpt} bf16 layer_norm",
                lambda: fk.fused_residual_norm(xg, resg, wg, bg),
                lambda: fk.fused_residual_norm_plain(xg, resg, wg, bg),
                lambda: TF.layer_norm(xg + resg, (d_gpt,), wg, bg, 1e-5),
                "x + res, then F.layer_norm (two calls)",
                4 * rows * d_gpt * 2 + 2 * d_gpt * 2, 9.0 * rows * d_gpt,
                FP32_FLOP_PER_S,
                _fused_model("fused_residual_norm",
                             [(rows, d_gpt)] * 2 + [(d_gpt,)] * 2,
                             [(rows, d_gpt)] * 2))
    # K5: the bias_act program's gelu(x W + b) epilogue, 8192 x 4096
    xb, bb = r(rows, ffn), r(ffn, scale=0.5)
    timed["fused_bias_act"] = _time_fused(
        "fused_bias_act", f"{rows}x{ffn} bf16 gelu",
        lambda: fk.fused_bias_act(xb, bb, "gelu"),
        lambda: fk.fused_bias_act_plain(xb, bb, "gelu"),
        lambda: TF.gelu(xb + bb), "F.gelu(x + b) (two calls)",
        2 * rows * ffn * 2 + ffn * 2, 20.0 * rows * ffn, FP32_FLOP_PER_S,
        _fused_model("fused_bias_act", [(rows, ffn), (ffn,)],
                     [(rows, ffn)]))
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
        2.0 * rows * ffn * d_gpt, model=_fused_model(
            "fused_norm_linear", [(rows, d_gpt), (d_gpt, ffn), (ffn,)],
            [(rows, ffn)]))
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
                2.0 * rows * 3 * d_gpt * d_gpt, model=_fused_model(
                    "fused_norm_linear",
                    [(rows, d_gpt), (d_gpt, 3 * d_gpt), (3 * d_gpt,),
                     (d_gpt,), (d_gpt,)], [(rows, 3 * d_gpt)]))
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
        (rows * h + h * h + rows * h) * 2, 2.0 * rows * h * h,
        model=_fused_model("fused_rope_proj", [(rows, h), (h, h)],
                           [(rows, h)]))
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


def _profile(label, fn, groups=None, op_groups=None):
    """Run ``fn`` under torch.profiler; print the operators by device time
    and one JSON line with the device-busy share of the wall time and,
    for each of ``groups`` (name -> substrings of kernel names), its
    share of the device time; ``op_groups`` (name -> operator names)
    group the device time of the kernels each operator launched."""
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
    for group, ops in (op_groups or {}).items():
        secs = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.key in ops) * 1e-6
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


def _kv_census(eng):
    """The memory census's kv_cache while ``eng`` lives: the bytes of its
    kc/vc pages, exactly. Returns a weak reference to the engine, for
    ``_kv_dropped``."""
    import gc
    import weakref
    gc.collect()            # the phase's earlier engines, in cycles
    pages = sum(t.numel() * t.element_size() for t in eng.kc + eng.vc)
    got = _perf.census(include_unclaimed=False)["kv_cache"]
    log(json.dumps({"serve_llama": "memory census, kv_cache",
                    "census_gb": got / 1e9, "pages_gb": pages / 1e9}))
    if got != pages:
        raise AssertionError(f"serve_llama: census kv_cache {got} against "
                             f"the engine's pages {pages}")
    return weakref.ref(eng)


def _kv_dropped(ref):
    """Once the engine is dropped and collected, the census's kv_cache is
    0."""
    import gc
    gc.collect()
    left = _perf.census(include_unclaimed=False)["kv_cache"]
    log(json.dumps({"serve_llama": "memory census, kv_cache after the "
                    "engine is dropped", "collected": ref() is None,
                    "census_gb": left / 1e9}))
    if not (ref() is None and left == 0):
        raise AssertionError(f"serve_llama: kv_cache {left} after the "
                             f"engine (collected: {ref() is None})")


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
    a = sample(p8, 16, 123)[0]
    if a != sample(p8, 16, 123)[0]:
        raise AssertionError("two sampled runs under seed 123 differ")
    if a == sample(p8, 16, 124)[0]:
        raise AssertionError("seeds 123 and 124 sampled the same tokens")
    # three requests whose prefixes fill the pool exactly: each must take
    # a new block within 40 tokens, so every slot stalls and one is evicted
    trio = [p for p in p8 if len(p) % 32][:3]
    roomy = sample(trio, 40, 123)[0]
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
        kv = _kv_census(eng) if name == "plain" else None
        del eng
        if kv is not None:
            _kv_dropped(kv)
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
    # bench.py probes with the high-water mark set: the burst fills the
    # queue past it (TIER_REQUESTS > high water + TIER_BATCH), so some
    # requests are shed there, and every other request finishes
    if (probe["finished"] + probe["shed"] != TIER_REQUESTS
            or not probe["shed"] or probe["deadline_missed"]
            or probe["overloaded"]):
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


# ------------------------------------------------------------ paddle_api
# bench.py _bench_bert (:287-339): BERT-base, dropouts 0, the fused loss
BERT_BASE = dict(vocab_size=30592, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 fused_loss=True)
BERT_SHAPE = dict(b=48, s=512, h=12, d=64)        # its attention
BERT_STEPS, BERT_WARMUP = 10, 2
# bench.py's small BERT with 2 heads of 64 where it has 4 of 32: K1-K3 take
# head dims 64 and 128 only, and the parity run must launch them
BERT_TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=256,
                 max_position_embeddings=128, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
DISPATCH_OPS = 300          # bench.py _bench_dispatch: 128x128 matmuls


def _dispatch_overhead(paddle, card):
    """bench.py _bench_dispatch (:2242): a loop of DISPATCH_OPS 128x128
    fp32 ``paddle.matmul``s with grad recorded, under ``no_grad``, and the
    same loop on raw ``torch.matmul`` (the floor); host time a op after a
    warm-up, ending in a synchronize."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    xa = torch.randn(128, 128, generator=gen, device="cuda")
    wa = torch.randn(128, 128, generator=gen, device="cuda") / 128 ** 0.5
    x, w = paddle.to_tensor(xa), paddle.to_tensor(wa)
    w.stop_gradient = False

    def loop(mm, y, wt):
        for _ in range(DISPATCH_OPS):
            y = mm(y, wt)
        return y

    def us_per_op(mm, y, wt):
        loop(mm, y, wt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(mm, y, wt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DISPATCH_OPS * 1e6

    grad = us_per_op(paddle.matmul, x, w)
    with paddle.no_grad():
        no_grad = us_per_op(paddle.matmul, x, w)
    raw = us_per_op(torch.matmul, xa, wa)
    row = {"dispatch": "paddle.matmul 128x128 fp32", "ops": DISPATCH_OPS,
           "us_per_op_grad": grad, "us_per_op_no_grad": no_grad,
           "us_per_op_torch_matmul": raw, "card": card}
    log(json.dumps(row))
    return row


def _bert_launches(layers, fused=False, recompute=False, recorded=False):
    """A BERT step's launches: K1-K3 once a layer; with fusion K4 twice
    and K6 once a layer and K6 once for the MLM head; recompute reruns
    each layer's forward in the backward. ``recorded``: to_static's
    recording step, which runs eagerly."""
    fused = fused and not recorded
    want = {"flash_attention_fwd": layers * (2 if recompute else 1),
            "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}
    if fused:
        want["fused_residual_norm"] = 2 * layers * (2 if recompute else 1)
        want["fused_matmul"] = layers * (2 if recompute else 1) + 1
    return want


def _bert_step(paddle, model, opt, ids, events=None, amp_kw=None, want=None):
    """One step: forward (loss), backward, AdamW; returns the loss. Its
    launches must be ``want`` (by default one K1, K2 and K3 a layer)."""
    from paddle_tpu_torch import amp
    if want is None:
        want = _bert_launches(model.bert.cfg.num_hidden_layers)
    c0 = _counts()
    if events:
        events[0].record()
    with (amp.auto_cast(**amp_kw) if amp_kw else contextlib.nullcontext()):
        loss = model(ids, masked_lm_labels=ids)[2]
    if events:
        events[1].record()
    loss.backward()
    if events:
        events[2].record()
    opt.step()
    opt.clear_grad()
    if events:
        events[3].record()
    launched = _launched(c0, _counts())
    if launched != want:
        raise AssertionError(f"BERT step launched {launched}, wants {want}")
    return loss


def _bert_tiny_parity(paddle):
    """fp32 tiny BERT on the card against a CPU twin with the same weights:
    MLM and NSP logits within LOGITS_TOL, three AdamW steps' losses within
    LOSS_TOL; each card step launches K1, K2 and K3 once a layer."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    b, s = 2, 128
    paddle.seed(11)
    card = BertForPretraining(BertConfig(**BERT_TINY, fused_loss=True))
    state = {k: v.numpy() for k, v in card.state_dict().items()}
    with paddle.device_guard("cpu"):
        twin = BertForPretraining(BertConfig(**BERT_TINY, fused_loss=True))
        twin.set_state_dict(state)
    batches = [np.random.RandomState(40 + i).randint(
        0, BERT_TINY["vocab_size"], (b, s)) for i in range(3)]
    with paddle.no_grad():          # no labels: (MLM logits, NSP logits)
        got = card(paddle.to_tensor(batches[0]))
        with paddle.device_guard("cpu"):
            ref = twin(paddle.to_tensor(batches[0]))
    err = max(float(np.abs(g.numpy() - r.numpy()).max())
              for g, r in zip(got, ref))
    losses = []
    for model, dev in ((card, None), (twin, "cpu")):
        guard = (paddle.device_guard(dev) if dev
                 else contextlib.nullcontext())
        with guard:
            opt = paddle.optimizer.AdamW(learning_rate=LR,
                                         parameters=model.parameters(),
                                         **ADAMW)
            run = []
            for ids in batches:
                t = paddle.to_tensor(ids)
                if dev:
                    loss = model(t, masked_lm_labels=t)[2]
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                else:
                    loss = _bert_step(paddle, model, opt, t)
                run.append(float(loss.item()))
            losses.append(run)
    loss_err = max(abs(a - c) for a, c in zip(*losses))
    log(f"paddle_api: tiny BERT fp32 card vs CPU: logits max abs err {err:.3e}"
        f" (limit {LOGITS_TOL}); losses {losses[0]} vs {losses[1]}, max err "
        f"{loss_err:.3e} (limit {LOSS_TOL})")
    if not (err <= LOGITS_TOL and loss_err <= LOSS_TOL):
        raise AssertionError("tiny BERT: the card disagrees with its CPU "
                             "twin")


def _bert_kernels(state):
    """K1-K3 at BERT-base's attention (B48 S512 H12 d64, non-causal), bf16:
    K1 against its plain version (BF16_TOL), K2/K3 norm-wise against the
    plain backward (BWD_LIMITS), two K2/K3 calls bitwise equal; each timed
    beside its bound and SDPA. The rows go under each kernel's "shapes" in
    the kernels line."""
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    sh = BERT_SHAPE
    err, lse_err, blind = _kernel_case(fa, sh["b"], sh["s"], sh["s"],
                                       sh["h"], sh["d"], False, True,
                                       torch.bfloat16, gen)
    q, k, v, do = _bwd_inputs(sh["b"], sh["s"], sh["s"], sh["h"], sh["d"],
                              torch.bfloat16, gen)
    errs, _ = _bwd_case(fa, q, k, v, do, False)
    del q, k, v, do
    rel = [e[1] for e in errs]
    log(f"  bert attention bf16 non-causal: K1 max_abs_err={err:.3e} "
        f"lse_err={lse_err:.3e}; K2/K3 norm-wise dq/dk/dv {rel}")
    if not (err <= BF16_TOL and lse_err <= BF16_TOL
            and max(rel) <= BWD_LIMITS[torch.bfloat16]):
        raise AssertionError(f"K1-K3 at {sh}: fwd {err}, lse {lse_err}, "
                             f"bwd {rel}")
    _bwd_deterministic(fa, gen, (sh["b"], sh["s"], sh["h"], sh["d"]), False)
    rows = {"flash_attention_fwd": dict(_time_fwd(fa, gen, sh, False),
                                        max_abs_err=err)}
    for name, row in _time_bwd(fa, gen, sh, False).items():
        k_err = errs[0][0] if name.endswith("dq") else max(errs[1][0],
                                                          errs[2][0])
        rows[name] = dict(row, max_abs_err=k_err)
    for name, row in rows.items():
        k = state.setdefault("kernels", {}).setdefault(name, {})
        k.setdefault("shapes", [dict(k)] if k else []).append(row)
    return rows


def _bert_base_rung(paddle, card, profile, mode="eager", recompute=False):
    """bench.py's BERT-base rung: bf16-resident weights (every float
    parameter, LayerNorm too), AdamW with fp32 masters, O1 bf16, B=48,
    S=512, the fused loss; BERT_WARMUP steps, then BERT_STEPS timed, each
    on its own RandomState(i) batch with labels = ids (make_inputs),
    every step's launches held. ``mode``: "eager", "static" (to_static,
    fusion off) or "fused" (to_static, fusion on), which records on the
    first warm-up step. One JSON line; returns it."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    cfg = BertConfig(**BERT_BASE, recompute=recompute)
    b, s, layers = BERT_SHAPE["b"], BERT_SHAPE["s"], cfg.num_hidden_layers
    paddle.seed(12)
    model = BertForPretraining(cfg)
    model.to(dtype="bfloat16")
    n_params = sum(p.size for p in model.parameters())
    if mode != "eager":
        paddle.jit.to_static(model, full_graph=True)
    fused = mode == "fused"
    opt = paddle.optimizer.AdamW(learning_rate=LR, multi_precision=True,
                                 parameters=model.parameters(), **ADAMW)
    batches = [paddle.to_tensor(np.random.RandomState(i).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int64))
        for i in range(BERT_STEPS)]
    warm = [paddle.to_tensor(np.random.RandomState(1000 + i).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int64))
        for i in range(BERT_WARMUP)]
    paddle.set_flags({"FLAGS_enable_fusion": fused})
    try:
        warm_losses = []
        for k, ids in enumerate(warm):
            want = _bert_launches(layers, fused, recompute,
                                  recorded=mode != "eager" and k == 0)
            warm_losses.append(float(_bert_step(
                paddle, model, opt, ids, amp_kw=O1, want=want).item()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = _bert_launches(layers, fused, recompute)
        walls, split, losses = [], [], []
        for ids in batches:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = _bert_step(paddle, model, opt, ids, events, O1, want)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            split.append([events[j].elapsed_time(events[j + 1])
                          for j in range(3)])
            losses.append(float(loss.item()))
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = None
        if profile:
            prof = _profile(
                f"bert_base {mode} step",
                lambda: _bert_step(paddle, model, opt, batches[0],
                                   amp_kw=O1, want=want),
                groups={"K1-K3 attention": ("flash_fwd", "dq_", "dkv_"),
                        "K4": ("residual_norm",),
                        "K6": ("gemm_wgmma", "norm_rows"),
                        "cuBLAS GEMM": ("nvjet", "xmma", "cutlass", "cublas"),
                        "elementwise and reductions": (
                            "elementwise", "reduce", "vectorized")})
    finally:
        paddle.set_flags({"FLAGS_enable_fusion": False})
    q1, median, q3 = statistics.quantiles(walls, n=4)
    fwd, bwd, upd = (statistics.median(x[j] for x in split)
                     for j in range(3))
    tokens = b * s
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * s
    row = {"rung": f"bert_base O1 bf16 fused_loss B{b} S{s} {mode}"
                   + (" recompute" if recompute else ""),
           "card": card, "params": n_params, "steps": len(losses),
           "step_ms": median * 1e3, "step_ms_q1": q1 * 1e3,
           "step_ms_q3": q3 * 1e3, "forward_ms": fwd, "backward_ms": bwd,
           "optimizer_ms": upd, "tokens_per_s": tokens / median,
           "mfu": flops_per_token * tokens / median / BF16_FLOP_PER_S,
           "peak_memory_gb": peak, "warm_losses": warm_losses,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches_a_step": want,
           "fusion_stats": (model.forward.fusion_stats
                            if mode != "eager" else None),
           "switches": dict(amp="O1 bfloat16", bf16_weights=True,
                            master_weights="fp32", fused_loss=True,
                            recompute=recompute,
                            to_static=mode != "eager", fusion=fused)}
    if prof:
        row["profiled_device_ms"] = prof["device_busy_s"] * 1e3
        row["device_busy_share"] = prof["device_busy_share"]
    log(json.dumps(row))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"bert_base {mode}: losses {losses}")
    if fused and row["fusion_stats"]["rewritten"] != {
            "residual_norm": 2 * layers, "linear_act": layers + 1}:
        raise AssertionError(f"bert_base fused: rewritten "
                             f"{row['fusion_stats']['rewritten']}")
    del model, opt, batches, warm
    torch.cuda.empty_cache()
    return row


def phase_paddle_api(state):
    """The Paddle-API eager core on the card: dispatch overhead, a tiny
    BERT against its CPU twin, K1-K3 at BERT-base's attention, and
    bench.py's BERT-base rung."""
    import paddle_tpu_torch as paddle
    card = _card_line()
    with paddle.device_guard("gpu:0"):
        _dispatch_overhead(paddle, card)
        _bert_tiny_parity(paddle)
        # the comparisons and timings are not the main path: their
        # launches do not count
        counts = _counts()
        _bert_kernels(state)
        for name, n in counts.items():
            _wrapper(name).launches = n
        torch.cuda.empty_cache()
        row = _bert_base_rung(paddle, card, state.get("profile"))
        state["paddle_api_step_ms"] = row["step_ms"]
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- perf
PERF_STEPS = 3              # steps of the per-op and the attribution pass
PERF_TIMED = 6              # steps a leg of the cost of turning it on
PERF_PROFILE = dict(closed=1, ready=1, record=3)     # 5 profiled steps
PERF_ROOF = 105.0           # % of the roofline no op's row may pass
PERF_FLOPS_TOL = 0.05       # modeled forward FLOPs against FlopCounterMode
PERF_SUM_TOL = 0.01         # the attribution's four parts against the step
#: the device kernel each of K1-K3's bf16 launches names in the trace
PERF_DEVICE_KERNELS = {"flash_attention_fwd": "flash_fwd_wgmma",
                       "flash_attention_bwd_dq": "dq_wgmma",
                       "flash_attention_bwd_dkv": "dkv_wgmma"}


def _perf_step_ms(step, batches):
    """Median wall ms of ``step(ids)`` over ``batches``, each between two
    synchronizes."""
    walls = []
    for ids in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(ids)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def _perf_op_pass(paddle, model, step, batches, layers):
    """1. The per-op pass: FLAGS_enable_metrics, FLAGS_perf_op_cost and
    FLAGS_benchmark on, PERF_STEPS steps; the report's rows through
    perf_report.build_report; the attention row's calls against K1's
    counter, the modeled forward FLOPs of a step against FlopCounterMode
    over one forward, no row above PERF_ROOF % of its roofline. Returns
    (report, the modeled and counted FLOPs)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.observability import REGISTRY
    from paddle_tpu_torch.tools import perf_report
    modeled_ops = _perf.attach_cost_models()
    paddle.set_flags({"FLAGS_enable_metrics": True,
                      "FLAGS_perf_op_cost": True, "FLAGS_benchmark": True})
    try:
        REGISTRY.reset()
        c0 = _counts()
        for ids in batches[:PERF_STEPS]:
            step(ids)
        k1 = _launched(c0, _counts()).get("flash_attention_fwd", 0)
        op_time, op_cost, _ = perf_report._series_tables(
            REGISTRY.snapshot())
    finally:
        paddle.set_flags({"FLAGS_enable_metrics": False,
                          "FLAGS_perf_op_cost": False,
                          "FLAGS_benchmark": False})
    report = perf_report.build_report(
        op_time, op_cost, cost_window_steps=PERF_STEPS,
        device_info={"device_kind": torch.cuda.get_device_name(),
                     "platform": "gpu"})
    for row in report["ops"][:10]:
        log(json.dumps({"perf": "op row (top 10 by host time, a synchronize"
                        " after each op)", **row}))
    attn = [r for r in report["ops"]
            if r["op"] == "scaled_dot_product_attention"]
    if not attn or attn[0]["calls"] != k1 or k1 != layers * PERF_STEPS:
        raise AssertionError(f"perf: the attention row {attn} against K1's "
                             f"{k1} launches")
    worst = max(report["ops"], key=lambda r: r["pct_of_roofline"])
    modeled = sum(float(c["flops"]) for c in op_cost.values()) / PERF_STEPS
    ids = batches[0]
    with amp.auto_cast(**O1):
        loss, counted = _perf.counted_cost(
            lambda: model(ids, masked_lm_labels=ids)[2])
    del loss
    counted = counted["flops"]
    err = abs(modeled - counted) / counted
    log(json.dumps({"perf": "per-op pass", "steps": PERF_STEPS,
                    "ops": len(report["ops"]),
                    "ops_with_a_cost_model": modeled_ops,
                    "attention_calls": attn[0]["calls"], "k1_launches": k1,
                    "modeled_forward_flops": modeled,
                    "flop_counter_forward_flops": counted,
                    "relative_error": err, "limit": PERF_FLOPS_TOL,
                    "worst_roofline_row": {k: worst[k] for k in (
                        "op", "calls", "pct_of_roofline", "bound",
                        "arithmetic_intensity")},
                    "roofline_limit_pct": PERF_ROOF,
                    "device": report["device"]}))
    if not err <= PERF_FLOPS_TOL:
        raise AssertionError(f"perf: modeled forward FLOPs {modeled:.4e} "
                             f"against FlopCounterMode's {counted:.4e}")
    if worst["pct_of_roofline"] > PERF_ROOF:
        raise AssertionError(f"perf: {worst['op']} at "
                             f"{worst['pct_of_roofline']}% of its roofline:"
                             f" its cost model is wrong")
    return report, modeled, counted


def _perf_attribution(step, ids):
    """2. The step split into compute / collective / host / idle by
    perf.step_attribution (every new flag off): the parts sum to each
    step within PERF_SUM_TOL."""
    att = _perf.step_attribution(lambda: step(ids), iters=PERF_STEPS,
                                 warmup=0, name="bert_step")
    for st in att["steps"] + [att["total"]]:
        parts = (st["compute_s"] + st["collective_s"] + st["host_s"]
                 + st["idle_s"])
        if not abs(parts - st["step_s"]) <= PERF_SUM_TOL * st["step_s"]:
            raise AssertionError(f"perf: attribution parts {parts} against "
                                 f"the step {st['step_s']}")
    tot = att["total"]
    n = tot["n_steps"]
    log(json.dumps({"perf": "step attribution", "steps": n,
                    **{f"{k}_ms": tot[f"{k}_s"] / n * 1e3 for k in (
                        "step", "compute", "collective", "host", "idle")},
                    **{f"{k}_frac": tot[f"{k}_frac"] for k in (
                        "compute", "collective", "host", "idle")}}))
    return att


def _perf_census(paddle, model, opt, ids, baseline):
    """3. The memory census at a step's high water (after the optimizer's
    step, the gradients still held): params, grads and optimizer_state
    equal to the bytes of the model's parameters, their gradients and
    the optimizer's moments and fp32 masters, exactly (over
    ``baseline``, the census before the model was built); the claimed
    total at most torch.cuda.memory_allocated(), the high water at most
    torch.cuda.max_memory_allocated()."""
    from paddle_tpu_torch import amp
    memory = _perf.memory
    memory.reset_high_water()
    with amp.auto_cast(**O1):
        loss = model(ids, masked_lm_labels=ids)[2]
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    got = memory.update_high_water("bert_step")
    params = [p._data for p in model.parameters()]

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    want = {"params": nbytes(params),
            "grads": nbytes(p.grad for p in params if p.grad is not None),
            "optimizer_state": nbytes(
                [t for st in opt._accumulators.values()
                 for t in st.values()] + list(opt._master_weights.values()))}
    allocated = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    hw = memory.high_water("bert_step")
    opt.clear_grad()
    del loss
    claimed = sum(got[k] for k in ("params", "grads", "optimizer_state",
                                   "kv_cache"))
    log(json.dumps({"perf": "memory census at the step's high water",
                    **{f"{k}_gb": got[k] / 1e9 for k in memory.TAGS},
                    "claimed_gb": claimed / 1e9,
                    "baseline_gb": {k: baseline[k] / 1e9 for k in want},
                    "want_gb": {k: v / 1e9 for k, v in want.items()},
                    "memory_allocated_gb": allocated / 1e9,
                    "high_water_gb": hw["total"] / 1e9,
                    "max_memory_allocated_gb": peak / 1e9}))
    for k, v in want.items():
        if got[k] - baseline[k] != v:
            raise AssertionError(f"perf: census {k} {got[k]} (baseline "
                                 f"{baseline[k]}) against {v}")
    if not (claimed <= allocated and hw["total"] <= peak):
        raise AssertionError(f"perf: claimed {claimed} against allocated "
                             f"{allocated}, high water {hw['total']} "
                             f"against the peak {peak}")


def _perf_profiler(paddle, model, opt, batches, layers):
    """4. paddle.profiler with the CPU and GPU targets, closed 1, ready 1,
    record 3 over 5 steps, RecordEvent forward/backward/optimizer in each:
    op_stats' attention calls and K1's counter over the window are
    layers x 3, the device trace names K1's, K2's and K3's kernels as
    often, the host file holds 3 forward ranges."""
    from paddle_tpu_torch import amp, profiler
    tmp = tempfile.mkdtemp(prefix="chip_smoke_perf_")
    record = PERF_PROFILE["record"]
    window = PERF_PROFILE["closed"] + PERF_PROFILE["ready"]
    try:
        p = profiler.Profiler(
            targets=[profiler.ProfilerTarget.CPU,
                     profiler.ProfilerTarget.GPU],
            scheduler=profiler.make_scheduler(**PERF_PROFILE),
            on_trace_ready=profiler.export_chrome_tracing(tmp))
        with p:
            for i in range(window + record):
                if i == window:
                    c0 = _counts()
                ids = batches[i % len(batches)]
                with profiler.RecordEvent("forward"):
                    with amp.auto_cast(**O1):
                        loss = model(ids, masked_lm_labels=ids)[2]
                with profiler.RecordEvent("backward"):
                    loss.backward()
                with profiler.RecordEvent("optimizer"):
                    opt.step()
                    opt.clear_grad()
                p.step(num_samples=ids.shape[0])
            launched = _launched(c0, _counts())
        with open(p.device_trace_path) as f:
            device = json.load(f)["traceEvents"]
        with open(p.trace_path) as f:
            host = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in device if e.get("cat") == "kernel"]
        named = {k: sum(sub in name for name in kernels)
                 for k, sub in PERF_DEVICE_KERNELS.items()}
        forwards = sum(e.get("name") == "forward" and e.get("cat") == "user"
                       for e in host)
        calls = p.op_stats().get("scaled_dot_product_attention",
                                 {}).get("calls")
        log(json.dumps({"perf": "profiler", "step_info": p.step_info(),
                        "attention_calls": calls,
                        "launches_over_the_window": launched,
                        "device_trace_kernels": len(kernels),
                        "device_trace_k1_k3": named,
                        "host_forward_ranges": forwards,
                        "host_events": len(host),
                        "device_trace_mb": os.path.getsize(
                            p.device_trace_path) / 1e6}))
        want = layers * record
        if not (calls == want and all(launched.get(k) == want
                                      for k in PERF_DEVICE_KERNELS)
                and all(n == want for n in named.values())
                and forwards == record):
            raise AssertionError(f"perf: profiler window: attention calls "
                                 f"{calls}, launches {launched}, device "
                                 f"trace {named}, forwards {forwards}; "
                                 f"wants {want} and {record}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _perf_capture(paddle, model, ids):
    """6. A bf16 B48 S512 BERT-base to_static forward under
    FLAGS_perf_capture: one "to_static" record whose FLOPs are within
    PERF_FLOPS_TOL of FlopCounterMode over the eager forward, with
    peak_bytes > 0."""
    _perf.device.clear_compiled()

    def bert_forward(x):
        return model(x)
    static = paddle.jit.to_static(bert_forward, full_graph=True)
    paddle.set_flags({"FLAGS_perf_capture": True})
    try:
        with paddle.no_grad():
            static(ids)
    finally:
        paddle.set_flags({"FLAGS_perf_capture": False})
    progs = _perf.compiled_programs("to_static")
    with paddle.no_grad():
        out, counted = _perf.counted_cost(lambda: model(ids))
    del out
    err = (abs(progs[0]["flops"] - counted["flops"]) / counted["flops"]
           if len(progs) == 1 else None)
    log(json.dumps({"perf": "to_static capture (bf16 B48 S512 forward)",
                    "records": len(progs),
                    "record": progs[0] if progs else None,
                    "eager_flop_counter_flops": counted["flops"],
                    "relative_error": err, "limit": PERF_FLOPS_TOL}))
    if not (len(progs) == 1 and err <= PERF_FLOPS_TOL
            and progs[0]["peak_bytes"] > 0):
        raise AssertionError(f"perf: to_static capture {progs}")


def phase_perf(state):
    """Performance attribution on bench.py's BERT-base rung (paddle_api's
    settings, eager, AdamW, O1): the per-op roofline pass, the step
    attribution, the memory census, the profiler, the to_static capture
    and the cost of the new flags (module docstring)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    card = _card_line()
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with paddle.device_guard("gpu:0"):
        baseline = _perf.memory.census(include_unclaimed=False)
        cfg = BertConfig(**BERT_BASE)
        b, s, layers = BERT_SHAPE["b"], BERT_SHAPE["s"], \
            cfg.num_hidden_layers
        paddle.seed(12)
        model = BertForPretraining(cfg)
        model.to(dtype="bfloat16")
        opt = paddle.optimizer.AdamW(learning_rate=LR, multi_precision=True,
                                     parameters=model.parameters(), **ADAMW)
        batches = [paddle.to_tensor(np.random.RandomState(i).randint(
            0, cfg.vocab_size, (b, s)).astype(np.int64))
            for i in range(PERF_TIMED)]
        want = _bert_launches(layers)

        def step(ids):
            return _bert_step(paddle, model, opt, ids, amp_kw=O1, want=want)
        for ids in batches[:2]:                  # warm-up
            step(ids)
        # 7. the cost of turning it on: every new flag off, then the op
        # costs accumulated (metrics on: the counters need them)
        off_ms = _perf_step_ms(step, batches)
        report, modeled, counted = _perf_op_pass(paddle, model, step,
                                                 batches, layers)
        paddle.set_flags({"FLAGS_enable_metrics": True,
                          "FLAGS_perf_op_cost": True})
        try:
            cost_ms = _perf_step_ms(step, batches)
        finally:
            paddle.set_flags({"FLAGS_enable_metrics": False,
                              "FLAGS_perf_op_cost": False})
        att = _perf_attribution(step, batches[0])
        _perf_census(paddle, model, opt, batches[1], baseline)
        _perf_profiler(paddle, model, opt, batches, layers)
        _perf_capture(paddle, model, batches[0])
        log(json.dumps({"perf": "cost of turning it on (not gated)",
                        "card": card,
                        "step_ms_flags_off": off_ms,
                        "step_ms_metrics_and_op_cost": cost_ms,
                        "paddle_api_rung_step_ms":
                            state.get("paddle_api_step_ms"),
                        "attributed_step_ms": att["total"]["step_s"]
                        / att["total"]["n_steps"] * 1e3,
                        "modeled_mfu_flags_off": 3 * modeled
                        / (off_ms / 1e3) / BF16_FLOP_PER_S,
                        "steps_a_leg": len(batches)}))
        del model, opt, batches, report
    gc.collect()
    torch.cuda.empty_cache()
    log(f"perf: phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------- paddle_static
# bench.py _bench_fusion (:1709-1895) at full size, in its Paddle-API
# spelling; fp32, as bench.py builds it
FUSION_BLOCK = dict(b=8, s=512, h=1024, ff=4096, heads=16, iters=20,
                    chunks=4)
FUSED_BLOCK = {"rope_proj": 2, "norm_linear": 1, "residual_norm": 1}
FUSED_BLOCK_LAUNCHES = {"fused_residual_norm": 1, "fused_matmul": 1,
                        "fused_matmul_rope": 2}
BLOCK_PARITY = 1e-3         # bench.py's two gates, relative


def _static_bert_tiny(paddle):
    """(a) The tiny fp32 BERT under to_static with fusion on the card
    against its CPU twin: a recording step, then three replayed AdamW
    steps' losses within LOSS_TOL; the pass's stats equal; the card's
    replays launch K4 and K6 as the pass predicts."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    b, s, layers = 2, 128, BERT_TINY["num_hidden_layers"]
    paddle.seed(11)
    card = BertForPretraining(BertConfig(**BERT_TINY, fused_loss=True))
    state = {k: v.numpy() for k, v in card.state_dict().items()}
    with paddle.device_guard("cpu"):
        twin = BertForPretraining(BertConfig(**BERT_TINY, fused_loss=True))
        twin.set_state_dict(state)
    batches = [np.random.RandomState(50 + i).randint(
        0, BERT_TINY["vocab_size"], (b, s)) for i in range(4)]
    losses, stats = [], []
    paddle.set_flags({"FLAGS_enable_fusion": True})
    for model, dev in ((card, None), (twin, "cpu")):
        guard = (paddle.device_guard(dev) if dev
                 else contextlib.nullcontext())
        with guard:
            paddle.jit.to_static(model, full_graph=True)
            opt = paddle.optimizer.AdamW(learning_rate=LR,
                                         parameters=model.parameters(),
                                         **ADAMW)
            run = []
            for k, ids in enumerate(batches):
                t = paddle.to_tensor(ids)
                if dev:
                    loss = model(t, masked_lm_labels=t)[2]
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                else:
                    loss = _bert_step(paddle, model, opt, t,
                                      want=_bert_launches(
                                          layers, fused=True,
                                          recorded=k == 0))
                run.append(float(loss.item()))
            losses.append(run[1:])
            stats.append(model.forward.fusion_stats)
    paddle.set_flags({"FLAGS_enable_fusion": False})
    loss_err = max(abs(a - c) for a, c in zip(*losses))
    want = {"residual_norm": 2 * layers, "linear_act": layers + 1}
    log(f"paddle_static: tiny BERT fp32 fused replays card vs CPU: losses "
        f"{losses[0]} vs {losses[1]}, max err {loss_err:.3e} (limit "
        f"{LOSS_TOL}); rewritten {stats[0]['rewritten']} and "
        f"{stats[1]['rewritten']}")
    if not (loss_err <= LOSS_TOL and stats[0] == stats[1]
            and stats[0]["rewritten"] == want):
        raise AssertionError("tiny BERT under to_static: the card disagrees "
                             "with its CPU twin")


def _static_fusion_block(paddle, card):
    """(b) bench.py's fusion block at full size in the Paddle API: the
    train leg (to_static(full_graph=True), (out*out).mean() and its
    backward) fused against unfused, the eager leg unfused against the
    F.fused_* spelling; interleaved chunks, the min of the chunk means;
    bench.py's two parity gates and the pass's rewrites."""
    from paddle_tpu_torch import nn, ops
    from paddle_tpu_torch.models import llama
    F = paddle.nn.functional
    fb = FUSION_BLOCK
    b, s, h, ff, heads = fb["b"], fb["s"], fb["h"], fb["ff"], fb["heads"]
    hd = h // heads
    paddle.seed(0)
    q_proj, k_proj = nn.Linear(h, h), nn.Linear(h, h)
    ln2 = nn.LayerNorm(h)
    fc1, fc2 = nn.Linear(h, ff), nn.Linear(ff, h)
    params = [p for m in (q_proj, k_proj, ln2, fc1, fc2)
              for p in m.parameters()]
    rng = np.random.RandomState(0)
    xs = [paddle.to_tensor((rng.randn(b, s, h) * 0.5).astype(np.float32))
          for _ in range(3)]

    def block(xt):
        hn = F.rms_norm(xt)
        q = llama.rotary_embedding(ops.reshape(q_proj(hn), [b, s, heads, hd]))
        k = llama.rotary_embedding(ops.reshape(k_proj(hn), [b, s, heads, hd]))
        out = fc2(F.gelu(fc1(ln2(xt))))
        y = F.rms_norm(xt + out)
        return y + ops.reshape(q, [b, s, h]) + ops.reshape(k, [b, s, h])

    def eager_fused(xt):
        hn = F.rms_norm(xt)
        q = F.fused_rope_proj(hn, q_proj.weight, q_proj.bias, num_heads=heads)
        k = F.fused_rope_proj(hn, k_proj.weight, k_proj.bias, num_heads=heads)
        out = fc2(F.fused_norm_linear(
            xt, fc1.weight, fc1.bias, ln2.weight, ln2.bias,
            activation="gelu", norm_type="layer_norm"))
        y, _ = F.fused_residual_norm(xt, out, norm_type="rms_norm",
                                     epsilon=1e-6)
        return y + ops.reshape(q, [b, s, h]) + ops.reshape(k, [b, s, h])

    sf = paddle.jit.to_static(block, full_graph=True)

    def train(x):
        out = sf(x)
        loss = (out * out).mean()
        loss.backward()
        for p in params:
            p.clear_gradient()
        return loss

    first = {}
    try:
        for fused in (False, True):
            paddle.set_flags({"FLAGS_enable_fusion": fused})
            train(xs[0])                                  # records
            c0 = _counts()
            first[fused] = float(train(xs[0]).item())     # replays
            launched = _launched(c0, _counts())
            want = FUSED_BLOCK_LAUNCHES if fused else {}
            if launched != want:
                raise AssertionError(f"fusion block train step "
                                     f"(fused={fused}) launched {launched}")
        patterns = dict(sf.fusion_stats["rewritten"])

        def chunk(fn, flag):
            if flag is not None:
                paddle.set_flags({"FLAGS_enable_fusion": flag})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(fb["iters"]):
                fn(xs[i % len(xs)])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / fb["iters"]
        t_u, t_f = [], []
        for _ in range(fb["chunks"]):
            t_u.append(chunk(train, False))
            t_f.append(chunk(train, True))
    finally:
        paddle.set_flags({"FLAGS_enable_fusion": False})
    e_out_u = block(xs[0]).numpy()
    c0 = _counts()
    e_out_f = eager_fused(xs[0]).numpy()
    if _launched(c0, _counts()) != FUSED_BLOCK_LAUNCHES:
        raise AssertionError(f"the F.fused_* spelling launched "
                             f"{_launched(c0, _counts())}")
    e_u, e_f = [], []
    for _ in range(fb["chunks"]):
        e_u.append(chunk(block, None))
        e_f.append(chunk(eager_fused, None))
    dt_u, dt_f, e_dt_u, e_dt_f = min(t_u), min(t_f), min(e_u), min(e_f)
    loss_parity = abs(first[False] - first[True]) <= BLOCK_PARITY * max(
        abs(first[False]), 1.0)
    scale = max(float(np.abs(e_out_u).max()), 1e-6)
    eager_err = float(np.abs(e_out_u - e_out_f).max())
    row = {"fusion_block": f"B{b} S{s} H{h} FF{ff} heads{heads} fp32",
           "card": card, "patterns": patterns,
           "train_unfused_step_ms": dt_u * 1e3,
           "train_fused_step_ms": dt_f * 1e3, "train_ratio": dt_u / dt_f,
           "train_loss_unfused": first[False],
           "train_loss_fused": first[True], "loss_parity": loss_parity,
           "eager_unfused_step_ms": e_dt_u * 1e3,
           "eager_fused_step_ms": e_dt_f * 1e3, "eager_ratio": e_dt_u / e_dt_f,
           "eager_max_abs_err": eager_err, "eager_scale": scale,
           "eager_parity": eager_err <= BLOCK_PARITY * scale,
           "chunk_means_ms": {"train_unfused": [t * 1e3 for t in t_u],
                              "train_fused": [t * 1e3 for t in t_f],
                              "eager_unfused": [t * 1e3 for t in e_u],
                              "eager_fused": [t * 1e3 for t in e_f]}}
    log(json.dumps(row))
    if not (row["loss_parity"] and row["eager_parity"]
            and patterns == FUSED_BLOCK):
        raise AssertionError("fusion block: a parity gate failed or the "
                             f"pass rewrote {patterns}")
    return row


def _bert_fused_kernels(state):
    """K4 and K6 at the shapes the fused BERT-base step gives them (K4:
    the fp32 residual stream, 24576 x 768, LayerNorm; K6: the bf16 FFN
    up-projection with gelu and the MLM head's projection with
    gelu_tanh), each against its plain version and timed beside its
    bound, its plain version and a PyTorch yardstick; and the copy that
    hands K6 a Paddle (in, out) weight as (out, in) rows. The rows go
    under each kernel's "shapes" in the kernels line."""
    import paddle_tpu_torch.ops.cuda.fused_ops as fk
    TF = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    rows, d, ffn = BERT_SHAPE["b"] * BERT_SHAPE["s"], 768, 3072

    def r(*shape, dtype=torch.bfloat16, scale=1.0):
        return randn(shape, torch.float32, gen).mul_(scale).to(dtype)
    f32 = torch.float32
    x, res = r(rows, d, dtype=f32), r(rows, d, dtype=f32)
    w, bias = 1 + r(d, dtype=f32, scale=0.1), r(d, dtype=f32, scale=0.1)
    err = _fused_check("fused_residual_norm", f"bert {rows}x{d} ln", f32,
                       fk.fused_residual_norm(x, res, w, bias),
                       fk.fused_residual_norm_plain(x, res, w, bias))
    out = {"fused_residual_norm": [dict(_time_fused(
        "fused_residual_norm", f"{rows}x{d} fp32 layer_norm (BERT-base)",
        lambda: fk.fused_residual_norm(x, res, w, bias),
        lambda: fk.fused_residual_norm_plain(x, res, w, bias),
        lambda: TF.layer_norm(x + res, (d,), w, bias, 1e-5),
        "x + res, then F.layer_norm (two calls)",
        4 * rows * d * 4 + 2 * d * 4, 9.0 * rows * d, FP32_FLOP_PER_S,
        _fused_model("fused_residual_norm", [(rows, d)] * 2 + [(d,)] * 2,
                     [(rows, d)] * 2, f32)),
        max_abs_err=err)]}
    del x, res
    xm = r(rows, d)
    out["fused_matmul"] = []
    for n, act in ((ffn, "gelu"), (d, "gelu_tanh")):
        wm, bm = r(n, d, scale=d ** -0.5), r(n, scale=0.1)
        err = _fused_check("fused_matmul", f"bert {rows}x{d}->{n} {act}",
                           torch.bfloat16, fk.fused_matmul(xm, wm, bm, act=act),
                           fk.fused_matmul_plain(xm, wm, bm, act=act))
        out["fused_matmul"].append(dict(_time_fused(
            "fused_matmul", f"{rows}x{d}->{n} bf16 bias {act} (BERT-base)",
            lambda: fk.fused_matmul(xm, wm, bm, act=act),
            lambda: fk.fused_matmul_plain(xm, wm, bm, act=act),
            lambda: TF.gelu(torch.addmm(bm, xm, wm.t()),
                            approximate="tanh" if act == "gelu_tanh"
                            else "none"),
            "torch.addmm, then F.gelu (two calls)",
            (rows * d + n * d + rows * n + n) * 2, 2.0 * rows * n * d,
            model=_fused_model("fused_norm_linear",
                               [(rows, d), (d, n), (n,)], [(rows, n)])),
            max_abs_err=err))
        paddle_w = wm.t().contiguous()          # a Paddle (in, out) weight
        copy_ms, _, _ = time_ms(lambda: paddle_w.t().contiguous(),
                                reps=KERNEL_REPS, queued=True)
        moved = 2 * n * d * 2
        log(json.dumps({"weight_copy": f"({d}, {n}) bf16 -> ({n}, {d})",
                        "ms": copy_ms, "bound_ms": moved / HBM_BYTES_PER_S
                        * 1e3, "bound_by": "bytes",
                        "kernel_ms": out["fused_matmul"][-1]["ms"]}))
    for name, found in out.items():
        k = state.setdefault("kernels", {}).setdefault(name, {})
        k.setdefault("shapes", [dict(k)] if k else []).extend(found)


def phase_paddle_static(state):
    """to_static over Paddle-API Layers: the tiny BERT card against CPU,
    bench.py's fusion block at full size, the BERT-base rung eager,
    to_static unfused and fused, and fused with recompute; then K4 and K6
    at the fused BERT step's shapes."""
    import paddle_tpu_torch as paddle
    card = _card_line()
    t0 = time.perf_counter()
    with paddle.device_guard("gpu:0"):
        _static_bert_tiny(paddle)
        _static_fusion_block(paddle, card)
        torch.cuda.empty_cache()
        profile = state.get("profile")
        runs = {mode: _bert_base_rung(paddle, card, profile, mode)
                for mode in ("eager", "static", "fused")}
        rc = _bert_base_rung(paddle, card, profile, "fused", recompute=True)
        step1 = {m: r["warm_losses"][1] for m, r in runs.items()}
        log(json.dumps({"bert_base_three_ways": {
            m: {"step_ms": r["step_ms"], "step_ms_q1": r["step_ms_q1"],
                "step_ms_q3": r["step_ms_q3"], "forward_ms": r["forward_ms"],
                "backward_ms": r["backward_ms"],
                "optimizer_ms": r["optimizer_ms"],
                "tokens_per_s": r["tokens_per_s"], "mfu": r["mfu"],
                "peak_memory_gb": r["peak_memory_gb"]}
            for m, r in dict(runs, fused_recompute=rc).items()},
            "first_replayed_step_loss": dict(step1,
                                             fused_recompute=rc[
                                                 "warm_losses"][1]),
            "card": card}))
        if not abs(step1["fused"] - step1["static"]) <= FUSED_LOSS_TOL:
            raise AssertionError(f"bert_base: fused first replayed loss "
                                 f"{step1['fused']} against unfused "
                                 f"{step1['static']}")
        if not abs(rc["warm_losses"][1] - step1["fused"]) <= BF16_TOL:
            raise AssertionError(f"bert_base: fused recompute first loss "
                                 f"{rc['warm_losses'][1]} against "
                                 f"{step1['fused']}")
        counts = _counts()
        _bert_fused_kernels(state)
        for name, n in counts.items():
            _wrapper(name).launches = n
    torch.cuda.empty_cache()
    log(f"paddle_static: phase took {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------------- sot
# bench.py's BERT rung (paddle_api's settings) through a host read in the
# middle of its forward, under to_static(full_graph=False)
SOT_STEPS, SOT_WARMUP = 6, 2
SOT_CALLS = 12              # timed serving calls of each leg
SOT_TRAIN = ("eager", "sot", "sot_fused")


def _guarded_bert(paddle):
    """BertForPretraining whose forward (models/bert.py:144) reads the
    encoder output's finiteness on the host before the heads: the
    overflow guard users write, two SOT segments a call."""
    from paddle_tpu_torch.models import BertForPretraining
    F = paddle.nn.functional

    class GuardedBert(BertForPretraining):
        def forward(self, input_ids, token_type_ids=None,
                    attention_mask=None, masked_lm_labels=None,
                    next_sentence_labels=None):
            seq, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask)
            if not bool(paddle.isfinite(seq).all()):
                raise FloatingPointError("BERT: a non-finite encoder output")
            h = self.mlm_norm(F.gelu(self.mlm_dense(seq), approximate=True))
            w = self.bert.embeddings.word_embeddings.weight
            nsp_logits = self.nsp(pooled)
            if masked_lm_labels is None:
                return paddle.matmul(h, w, transpose_y=True), nsp_logits
            loss = F.fused_linear_cross_entropy(
                paddle.reshape(h, [-1, self.bert.cfg.hidden_size]), w,
                paddle.reshape(masked_lm_labels, [-1]), transpose_y=True,
                ignore_index=-100)
            if next_sentence_labels is not None:
                loss = loss + F.cross_entropy(nsp_logits,
                                              next_sentence_labels)
            return None, nsp_logits, loss
    return GuardedBert


def _guarded_model(paddle, seed):
    from paddle_tpu_torch.models import BertConfig
    paddle.seed(seed)
    model = _guarded_bert(paddle)(BertConfig(**BERT_BASE))
    model.to(dtype="bfloat16")
    return model


def _sot_launches(layers, mode, first=False):
    """A training step's launches: _bert_launches' (fused for sot_fused);
    the first to_static step records the encoder eagerly up to the host
    read, then runs the call again under SOT: K1 once more a layer."""
    want = _bert_launches(layers, fused=mode == "sot_fused")
    if first and mode != "eager":
        want["flash_attention_fwd"] += layers
    return want


def _sot_train(paddle, card, mode):
    """(a) one leg: bench.py's BERT rung settings on the guarded model,
    eagerly ("eager") or under to_static(full_graph=False), unfused
    ("sot") or fused ("sot_fused"). One JSON line; returns it."""
    b, s = BERT_SHAPE["b"], BERT_SHAPE["s"]
    model = _guarded_model(paddle, 12)
    layers = model.bert.cfg.num_hidden_layers
    n_params = sum(p.size for p in model.parameters())
    if mode != "eager":
        paddle.jit.to_static(model, full_graph=False)
    opt = paddle.optimizer.AdamW(learning_rate=LR, multi_precision=True,
                                 parameters=model.parameters(), **ADAMW)
    vocab = BERT_BASE["vocab_size"]
    batches = [paddle.to_tensor(np.random.RandomState(i).randint(
        0, vocab, (b, s)).astype(np.int64)) for i in range(SOT_STEPS)]
    warm = [paddle.to_tensor(np.random.RandomState(1000 + i).randint(
        0, vocab, (b, s)).astype(np.int64)) for i in range(SOT_WARMUP)]
    sot_stats = []

    def step(ids, want, events=None):
        with warnings.catch_warnings():
            # the first call's graph-break warning
            warnings.simplefilter("ignore")
            loss = _bert_step(paddle, model, opt, ids, events, O1, want)
        if mode != "eager":
            sot_stats.append(dict(model.forward.sot_stats))
        return loss

    paddle.set_flags({"FLAGS_enable_fusion": mode == "sot_fused"})
    try:
        # the unfused leg's warm-up makes its segment plans under
        # FLAGS_perf_capture: each plan's analysis is kept under "sot"
        _perf.device.clear_compiled()
        paddle.set_flags({"FLAGS_perf_capture": mode == "sot"})
        try:
            warm_losses = [float(step(ids, _sot_launches(
                layers, mode, first=k == 0)).item())
                for k, ids in enumerate(warm)]
        finally:
            paddle.set_flags({"FLAGS_perf_capture": False})
        if mode == "sot":
            plans = _perf.compiled_programs("sot")
            log(json.dumps({"sot": "segment plans captured (FLAGS_perf_"
                            "capture)", "records": plans}))
            if len(plans) != 2 or not all(
                    p["flops"] > 0 and p["peak_bytes"] > 0 for p in plans):
                raise AssertionError(f"sot: captured plans {plans}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = _sot_launches(layers, mode)
        walls, hosts, split, losses = [], [], [], []
        for ids in batches:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(ids, want, events)
            hosts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            split.append([events[j].elapsed_time(events[j + 1])
                          for j in range(3)])
            losses.append(float(loss.item()))
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        paddle.set_flags({"FLAGS_enable_fusion": False})
    q1, median, q3 = statistics.quantiles(walls, n=4)
    fwd, bwd, upd = (statistics.median(x[j] for x in split)
                     for j in range(3))
    row = {"sot": f"bert_base O1 bf16 fused_loss B{b} S{s} train {mode}",
           "card": card, "params": n_params, "steps": len(losses),
           "step_ms": median * 1e3, "step_ms_q1": q1 * 1e3,
           "step_ms_q3": q3 * 1e3,
           "host_ms_a_step": statistics.median(hosts) * 1e3,
           "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": upd,
           "tokens_per_s": b * s / median, "peak_memory_gb": peak,
           "warm_losses": warm_losses, "losses": losses,
           "launches_a_step": want, "sot_stats": sot_stats}
    log(json.dumps(row))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"sot {mode}: losses {losses}")
    if mode != "eager":
        if any(st["segments"] != 2 or st["bypassed"] for st in sot_stats):
            raise AssertionError(f"sot {mode}: sot_stats {sot_stats}")
        if sot_stats[0]["compiled"] != 2 or any(
                st["compiled"] for st in sot_stats[1:]):
            raise AssertionError(f"sot {mode}: plans made {sot_stats}")
        rewritten = sot_stats[0].get("fusion_rewritten", 0)
        if rewritten != (3 * layers + 1 if mode == "sot_fused" else 0):
            raise AssertionError(f"sot {mode}: {rewritten} chains rewritten")
    del model, opt, batches, warm
    torch.cuda.empty_cache()
    return row


def _sot_demote(static_fn):
    """Make the next call of ``static_fn`` a Python replay, as a guard
    miss does (its journal is kept: the call after it bypasses again)."""
    for frame in static_fn._sot_frames.values():
        frame["stable"] = False


def _sot_err(got, ref):
    """The largest norm-wise error of the outputs, on the card."""
    return max(float(torch.linalg.vector_norm(g._data.float() - r)
                     / torch.linalg.vector_norm(r)) for g, r in zip(got, ref))


def _sot_serve(paddle, card, fused):
    """(b) the guarded model in eval with frozen bf16 weights at B48 S512:
    three calls (replay, replay, bypass) against eager, their launches;
    eager, replay and bypass timed in turns; then one weight changed in
    place and the next call held. One JSON line; returns it."""
    b, s = BERT_SHAPE["b"], BERT_SHAPE["s"]
    model = _guarded_model(paddle, 13)
    model.eval()
    for p in model.parameters():
        p.stop_gradient = True
    layers = model.bert.cfg.num_hidden_layers
    eager = model.forward                    # the bound method: eager
    ids = paddle.to_tensor(np.random.RandomState(7).randint(
        0, BERT_BASE["vocab_size"], (b, s)).astype(np.int64))
    ref = _uncounted(lambda: [o._data.float() for o in eager(ids)])
    paddle.jit.to_static(model, full_graph=False)
    static = model.forward
    want = {"flash_attention_fwd": layers}
    if fused:
        want.update(fused_residual_norm=2 * layers, fused_matmul=layers + 1)
    paddle.set_flags({"FLAGS_enable_fusion": fused})
    try:
        calls = []
        for k in range(3):
            before = _counts()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out = model(ids)
            launched = _launched(before, _counts())
            calls.append({"sot_stats": dict(static.sot_stats),
                          "launches": launched,
                          "norm_err_to_eager": _sot_err(out, ref)})
            del out
            first = dict(want, flash_attention_fwd=2 * layers)
            if launched != (first if k == 0 else want):
                raise AssertionError(f"sot serve call {k + 1}: launched "
                                     f"{launched}")

        def host(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            took = time.perf_counter() - t0
            torch.cuda.synchronize()
            return took * 1e3

        def replay():
            _sot_demote(static)
            model(ids)
        legs = {"eager": lambda: eager(ids), "replay": replay,
                "bypass": lambda: model(ids)}
        timed = _legs_ms(legs, uncounted=tuple(legs), runs=SOT_CALLS,
                         rounds=2)
        hosts = {name: _uncounted(lambda fn=fn: statistics.median(
            host(fn) for _ in range(5))) for name, fn in legs.items()}
        bypassed_after = static.sot_stats["bypassed"]
        # the live read: a weight changed in place, the next call bypasses
        w = model.nsp.weight
        w.set_value(w._data * 0.5)
        before = _counts()
        out = model(ids)
        live = {"sot_stats": dict(static.sot_stats),
                "launches": _launched(before, _counts())}
        new_ref = _uncounted(lambda: [o._data.float() for o in eager(ids)])
        live["norm_err_to_eager"] = _sot_err(out, new_ref)
        live["norm_change"] = _sot_err(out, ref)
        del out, new_ref, ref
    finally:
        paddle.set_flags({"FLAGS_enable_fusion": False})
    row = {"sot": f"bert_base bf16 B{b} S{s} serve "
                  f"{'fused' if fused else 'unfused'}",
           "card": card, "calls": calls, "tolerance": BF16_TOL,
           **{f"{name}_p50_ms": t[0] for name, t in timed.items()},
           **{f"{name}_q1_q3_ms": t[1:] for name, t in timed.items()},
           "host_ms_a_call": hosts, "live_weight_change": live}
    log(json.dumps(row))
    bypassed = [c["sot_stats"]["bypassed"] for c in calls]
    if bypassed != [False, False, True] or not bypassed_after:
        raise AssertionError(f"sot serve: bypassed {bypassed}, after the "
                             f"timed calls {bypassed_after}")
    if not max(c["norm_err_to_eager"] for c in calls) <= BF16_TOL:
        raise AssertionError(f"sot serve: calls {calls}")
    if not (live["sot_stats"]["bypassed"] and live["launches"] == want
            and live["norm_err_to_eager"] <= BF16_TOL
            and live["norm_change"] > 10 * BF16_TOL):
        raise AssertionError(f"sot serve: after the weight change {live}")
    del model, ids
    torch.cuda.empty_cache()
    return row


def phase_sot(state):
    """SOT partial-frame capture on bench.py's BERT-base rung through a
    host read in the middle of the forward: (a) trained three ways, (b)
    served unfused and fused (module docstring)."""
    import paddle_tpu_torch as paddle
    card = _card_line()
    t0 = time.perf_counter()
    with paddle.device_guard("gpu:0"):
        runs = {mode: _sot_train(paddle, card, mode) for mode in SOT_TRAIN}
        first = {m: r["warm_losses"][1] for m, r in runs.items()}
        log(json.dumps({"sot_three_ways": {
            m: {"step_ms": r["step_ms"], "step_ms_q1": r["step_ms_q1"],
                "step_ms_q3": r["step_ms_q3"],
                "host_ms_a_step": r["host_ms_a_step"],
                "tokens_per_s": r["tokens_per_s"],
                "peak_memory_gb": r["peak_memory_gb"]}
            for m, r in runs.items()},
            "first_replayed_step_loss": first, "card": card}))
        if not abs(first["sot"] - first["eager"]) <= BF16_TOL:
            raise AssertionError(f"sot: first replayed loss {first['sot']} "
                                 f"against eager {first['eager']}")
        if not abs(first["sot_fused"] - first["eager"]) <= FUSED_LOSS_TOL:
            raise AssertionError(f"sot: fused first replayed loss "
                                 f"{first['sot_fused']} against eager "
                                 f"{first['eager']}")
        for fused in (False, True):
            _sot_serve(paddle, card, fused)
    torch.cuda.empty_cache()
    log(f"sot: phase took {time.perf_counter() - t0:.1f} s")


# The checkpoint phase: the BERT-base rung's train state saved at
# CKPT_SAVES of CKPT_STEPS steps (the run cut after the last save), its
# scheduler a StepDecay whose first decay lies past the phase, so the
# rate is the rung's LR and the scheduler's state is in the checkpoint
CKPT_STEPS = 8
CKPT_SAVES = (2, 4)
CKPT_SEEDS = (12, 99)           # the trained runs, the fresh resumed model
CKPT_CHILD_TIMEOUT = 300
_MTTR_CHILD = ("import sys, time; t0 = time.time(); "
               "sys.path.insert(0, sys.argv[1]); import chip_smoke; "
               "chip_smoke._mttr_child(sys.argv[2], sys.argv[3], t0)")


def _ckpt_model(paddle, seed, names=None):
    """bench.py's BERT-base rung (BERT_BASE, bf16 weights, fp32 masters,
    AdamW) built from ``seed``, with its StepDecay scheduler. ``names``
    renames the parameters: the optimizer keys its state by parameter
    name, so a state saved by another model of this process restores its
    moments only under that model's names (a new process builds the same
    names)."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    paddle.seed(seed)
    model = BertForPretraining(BertConfig(**BERT_BASE))
    model.to(dtype="bfloat16")
    if names is not None:
        for p, n in zip(model.parameters(), names):
            p.name = n
    sched = paddle.optimizer.lr.StepDecay(LR, step_size=1000, gamma=0.5)
    opt = paddle.optimizer.AdamW(learning_rate=sched, multi_precision=True,
                                 parameters=model.parameters(), **ADAMW)
    return model, opt, sched


def _ckpt_steps(paddle, model, opt, sched, batches):
    """The rung's O1 steps on RandomState(i) batches for i in ``batches``
    (K1-K3 once a layer a step, _bert_step holds it); the losses."""
    losses = []
    b, s = BERT_SHAPE["b"], BERT_SHAPE["s"]
    for i in batches:
        ids = paddle.to_tensor(np.random.RandomState(i).randint(
            0, BERT_BASE["vocab_size"], (b, s)).astype(np.int64))
        loss = _bert_step(paddle, model, opt, ids, amp_kw=O1)
        sched.step()
        losses.append(float(loss.item()))
    return losses


def _ckpt_warm(paddle, model, opt, sched):
    """The rung's warm-up: BERT_WARMUP steps on RandomState(1000 + i)."""
    _ckpt_steps(paddle, model, opt, sched,
                [1000 + i for i in range(BERT_WARMUP)])


def _flat_state(model, opt):
    """A host copy of the train state: every parameter and buffer, every
    optimizer tensor (moments, masters), @step_count and the scheduler."""
    out = {f"model.{k}": v._data.detach().cpu().clone()
           for k, v in model.state_dict().items()}
    for k, v in opt.state_dict().items():
        out[f"optimizer.{k}"] = (v.detach().cpu().clone()
                                 if isinstance(v, torch.Tensor) else v)
    return out


def _unequal(want, got):
    """Keys of ``want`` whose value in ``got`` is missing or not bit for
    bit the same (dtype, shape and bytes)."""
    bad = []
    for k, v in want.items():
        w = got.get(k)
        if isinstance(v, torch.Tensor):
            same = (isinstance(w, torch.Tensor) and v.dtype == w.dtype
                    and v.shape == w.shape and torch.equal(
                        v.reshape(-1).view(torch.uint8),
                        w.reshape(-1).view(torch.uint8)))
        else:
            same = k in got and w == v
        if not same:
            bad.append(k)
    return bad + [k for k in got if k not in want]


def _save_split(directory, state):
    """framework.io.save's three costs, each timed apart on ``state``: the
    host copy (``_pack``: every tensor to host memory), the two CRC32
    passes its writer makes over every byte (the region CRC and the
    whole-blob digest), and the write of those bytes with the fsync."""
    from paddle_tpu_torch.framework import io as fio
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segments = []
    fio._pack({"state": state, "meta": {}}, segments, [])
    t1 = time.perf_counter()
    views = [memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
             for a, _ in segments]
    for _ in range(2):
        for v in views:
            zlib.crc32(v)
    t2 = time.perf_counter()
    raw = os.path.join(directory, "split.raw")
    with open(raw, "wb") as f:
        for v in views:
            f.write(v)
        f.flush()
        os.fsync(f.fileno())
    t3 = time.perf_counter()
    os.unlink(raw)
    return {"host_copy_s": t1 - t0, "crc_s": t2 - t1,
            "write_fsync_s": t3 - t2,
            "segment_bytes": sum(v.nbytes for v in views)}


def _ckpt_bert(paddle, card, directory):
    """BERT-base's train state at the rung's settings: two uninterrupted
    runs of CKPT_STEPS steps (do they agree bitwise?), a third saved at
    CKPT_SAVES and cut, a fresh model from another seed auto_resumed
    (state bitwise equal to a host copy, every moment restored) and
    retrained to CKPT_STEPS (losses bitwise equal to the uninterrupted
    ones, or within their spread when those differ); then the flipped-byte
    fallback and the truncated file's named error. One JSON line each:
    save/load, resume, drills."""
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.framework import io as fio
    from paddle_tpu_torch.observability import goodput
    free = shutil.disk_usage(directory).free
    log(f"checkpoint: {free} bytes free under {directory}")
    runs = []
    for _ in range(2):
        model, opt, sched = _ckpt_model(paddle, CKPT_SEEDS[0])
        n_params = sum(p.size for p in model.parameters())
        # bf16 weights, fp32 masters and two fp32 moments
        expect = n_params * (2 + 4 + 4 + 4)
        if free < 3 * expect:
            raise RuntimeError(f"{free} bytes free, below three "
                               f"checkpoints of about {expect}")
        _ckpt_warm(paddle, model, opt, sched)
        runs.append(_ckpt_steps(paddle, model, opt, sched,
                                range(CKPT_STEPS)))
        del model, opt, sched
        torch.cuda.empty_cache()
    bitwise_runs = runs[0] == runs[1]
    spread = max(abs(a - b) for a, b in zip(*runs))

    goodput.reset_ledger()
    goodput.ledger().run_begin()
    mgr = fault.CheckpointManager(directory, keep_n=2)
    model, opt, sched = _ckpt_model(paddle, CKPT_SEEDS[0])
    names = [p.name for p in model.parameters()]
    _ckpt_warm(paddle, model, opt, sched)
    save_s = []
    for step in range(1, CKPT_SAVES[-1] + 1):
        _ckpt_steps(paddle, model, opt, sched, [step - 1])
        if step in CKPT_SAVES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = mgr.save(fault.capture_train_state(model, opt),
                            step=step, epoch=0,
                            meta={"step_in_epoch": step - 1})
            save_s.append(time.perf_counter() - t0)
    host = _flat_state(model, opt)
    split = _save_split(directory, fault.capture_train_state(model, opt))
    nbytes = os.path.getsize(path)
    del model, opt, sched
    torch.cuda.empty_cache()

    model, opt, sched = _ckpt_model(paddle, CKPT_SEEDS[1], names)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = fault.auto_resume(fault.CheckpointManager(directory, keep_n=2),
                             network=model, optimizer=opt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad = _unequal(host, _flat_state(model, opt))
    restored = sum(1 for n in names if n in opt._accumulators)
    # the pooler and NSP head take no gradient from the MLM loss: no state
    stateful = sum(1 for n in names if f"optimizer.{n}_moment1" in host)
    resumed = _ckpt_steps(paddle, model, opt, sched,
                          range(CKPT_SAVES[-1], CKPT_STEPS))
    del model, opt, sched, host
    torch.cuda.empty_cache()
    want = runs[0][CKPT_SAVES[-1]:]
    resumed_diff = max(abs(a - b) for a, b in zip(resumed, want))
    loads = {}
    for verify in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = fio.load(path, verify=verify)
        torch.cuda.synchronize()
        loads[verify] = time.perf_counter() - t0
        del loaded
    torch.cuda.empty_cache()
    snap = goodput.ledger().snapshot()
    goodput.ledger().run_end()
    total = sum(save_s) / len(save_s)
    log(json.dumps({
        "checkpoint": "bert_base train state (bf16 weights, fp32 masters, "
                      "AdamW fp32 moments)", "card": card,
        "params": n_params, "bytes": nbytes, "saves_s": save_s,
        "save_gb_per_s": [nbytes / t / 1e9 for t in save_s],
        "save_split_s": split,
        "save_split_share": {k: split[k] / total for k in
                             ("host_copy_s", "crc_s", "write_fsync_s")},
        "restore_s": restore_s, "restore_gb_per_s": nbytes / restore_s / 1e9,
        "load_verify_s": loads[True],
        "load_verify_gb_per_s": nbytes / loads[True] / 1e9,
        "load_no_verify_s": loads[False],
        "load_no_verify_gb_per_s": nbytes / loads[False] / 1e9,
        "goodput_checkpoint_s": snap["buckets"].get("checkpoint"),
        "goodput_buckets_s": snap["buckets"]}))
    resume_ok = (resumed == want if bitwise_runs
                 else resumed_diff <= spread)
    log(json.dumps({
        "resume": "bert_base", "card": card, "restored_meta": meta,
        "state_unequal": bad[:10], "accumulators_restored": restored,
        "accumulators_saved": stateful, "params": len(names),
        "uninterrupted_losses": runs,
        "uninterrupted_bitwise": bitwise_runs,
        "uninterrupted_max_diff": spread, "resumed_losses": resumed,
        "resumed_max_diff": resumed_diff,
        "resumed_bitwise": resumed == want}))
    if bad or not 0 < restored == stateful or \
            meta.get("step") != CKPT_SAVES[-1] or not resume_ok:
        raise AssertionError(f"bert_base resume: unequal {bad[:10]}, "
                             f"{restored} of {stateful} moments, meta "
                             f"{meta}, losses {resumed} against {want}")

    # a byte flipped in the middle of the newest checkpoint
    with open(path, "r+b") as f:
        f.seek(nbytes // 2)
        byte = f.read(1)[0]
        f.seek(nbytes // 2)
        f.write(bytes([byte ^ 0x40]))
        f.flush()
        os.fsync(f.fileno())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, fallback_meta = mgr.restore()
    del state
    torch.cuda.empty_cache()
    warned = [str(w.message) for w in caught
              if issubclass(w.category, UserWarning)
              and "skipping" in str(w.message)]
    # a truncated copy of the other
    older = mgr.checkpoints()[-1]
    cut = os.path.join(directory, "truncated.pdckpt")
    with open(older, "rb") as f, open(cut, "wb") as g:
        g.write(f.read(os.path.getsize(older) // 2))
    section = None
    try:
        fio.load(cut)
    except fio.CheckpointCorruptError as e:
        section = e.section
    log(json.dumps({
        "drills": "bert_base checkpoint", "card": card,
        "flipped_byte_at": nbytes // 2,
        "fallback_depth": mgr.last_fallback_depth,
        "fallback_step": fallback_meta.get("step"), "warnings": warned,
        "truncated_bytes": os.path.getsize(older) // 2,
        "truncated_section": section}))
    if mgr.last_fallback_depth != 1 or \
            fallback_meta.get("step") != CKPT_SAVES[0] or len(warned) != 1 \
            or section is None:
        raise AssertionError(f"drills: depth {mgr.last_fallback_depth}, "
                             f"step {fallback_meta}, {warned}, {section}")
    for name in os.listdir(directory):
        os.unlink(os.path.join(directory, name))


def _mttr_child(mode, directory, t_start):
    """One process of the MTTR drill. ``save``: build BERT-base's train
    state on the card, train one step (the moments exist from then), save
    it through the manager, print the crash stamp and SIGKILL itself.
    ``resume``: build the same model from another seed, auto_resume it and
    print its stamps (wall clock) and the moments it restored."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import fault
    t_imports = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.time()
    with paddle.device_guard("gpu:0"):
        seed = CKPT_SEEDS[0] if mode == "save" else CKPT_SEEDS[1]
        model, opt, sched = _ckpt_model(paddle, seed)
        torch.cuda.synchronize()
        t_built = time.time()
        mgr = fault.CheckpointManager(directory, keep_n=1)
        if mode == "save":
            _ckpt_steps(paddle, model, opt, sched, [0])
            mgr.save(fault.capture_train_state(model, opt), step=1,
                     epoch=0, meta={"step_in_epoch": 0})
            print(json.dumps({"crash_at": time.time(),
                              "accumulators": len(opt._accumulators)}),
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        meta = fault.auto_resume(mgr, network=model, optimizer=opt)
        torch.cuda.synchronize()
        t_restored = time.time()
        print(json.dumps({
            "restored_step": meta["step"], "started_at": t_start,
            "imports_at": t_imports, "cuda_at": t_cuda, "built_at": t_built,
            "restored_at": t_restored,
            "accumulators": sum(1 for p in model.parameters()
                                if p.name in opt._accumulators),
            "params": len(model.parameters())}), flush=True)


def _ckpt_mttr(card, directory):
    """bench.py's _bench_fault_recovery drill (:2086-2120, _MTTR_CHILD),
    with chip_smoke.py relaunching the child itself: a child saves
    BERT-base's state and SIGKILLs itself, a second auto_resumes it. The
    time from the crash stamp to the restore, split into process start and
    imports, CUDA context, model build, and load with verification."""
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-c", _MTTR_CHILD, repo]
    saver = subprocess.run(cmd + ["save", directory], capture_output=True,
                           text=True, timeout=CKPT_CHILD_TIMEOUT)
    if saver.returncode != -signal.SIGKILL:
        raise AssertionError(f"the saving child ended with "
                             f"{saver.returncode}: {saver.stderr[-2000:]}")
    stamp = json.loads(saver.stdout.strip().splitlines()[-1])
    crash = stamp["crash_at"]
    resumer = subprocess.run(cmd + ["resume", directory], capture_output=True,
                             text=True, timeout=CKPT_CHILD_TIMEOUT)
    if resumer.returncode != 0:
        raise AssertionError(f"the resuming child ended with "
                             f"{resumer.returncode}: {resumer.stderr[-2000:]}")
    st = json.loads(resumer.stdout.strip().splitlines()[-1])
    log(json.dumps({
        "mttr": "bert_base SIGKILL -> auto_resume", "card": card,
        "relaunch": "chip_smoke.py relaunches the child itself (bench.py's "
                    "child runs under the elastic launcher, a later slice)",
        "mttr_s": st["restored_at"] - crash,
        "split_s": {"process_start_and_imports": st["imports_at"] - crash,
                    "cuda_context": st["cuda_at"] - st["imports_at"],
                    "model_build": st["built_at"] - st["cuda_at"],
                    "load_and_verify": st["restored_at"] - st["built_at"]},
        "interpreter_up_s": st["started_at"] - crash,
        "restored_step": st["restored_step"],
        "accumulators_restored": st["accumulators"],
        "accumulators_saved": stamp["accumulators"],
        "params": st["params"]}))
    if st["restored_step"] != 1 or \
            not 0 < st["accumulators"] == stamp["accumulators"]:
        raise AssertionError(f"mttr: {st}")
    for name in os.listdir(directory):
        os.unlink(os.path.join(directory, name))


def _ckpt_hapi(paddle, card, directory):
    """hapi at full width: ResNet-50 Model.fit at the vision phase's fit
    settings (fp32) with ModelCheckpoint(manager, save_steps=2) and a
    save_dir, cut after epoch 0; a fresh Model's fit(resume=manager) (its
    _global_step, the optimizer's _step_count, every moment and the
    weights right after the restore equal what was saved); Model.save and
    Model.load bitwise; summary's and flops' counts at 1x3x224x224 equal
    the JAX package's (RESNET50_PARAMS, RESNET50_FLOPS_224)."""
    from io import StringIO

    from paddle_tpu_torch.vision.models import resnet50
    data = _ImageSet(FIT_IMAGES, RESNET_RUNG["hw"], RESNET_RUNG["classes"],
                     seed=24)
    mgr = paddle.fault.CheckpointManager(os.path.join(directory, "mgr"),
                                         keep_n=2)

    def build(seed, names=None):
        paddle.seed(seed)
        net = resnet50(num_classes=RESNET_RUNG["classes"])
        if names is not None:
            for p, n in zip(net.parameters(), names):
                p.name = n
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=net.parameters(), **ADAMW)
        model = paddle.Model(net)
        model.prepare(opt, paddle.nn.CrossEntropyLoss())
        return model

    class CutAfterEpoch0(paddle.hapi.Callback):
        def on_epoch_end(self, epoch, logs=None):
            self.model.stop_training = True

    first = build(31)
    names = [p.name for p in first.network.parameters()]
    first.fit(data, batch_size=FIT_BATCH, epochs=FIT_EPOCHS, shuffle=True,
              num_workers=FIT_WORKERS, verbose=0,
              save_dir=os.path.join(directory, "fit"),
              callbacks=[paddle.hapi.ModelCheckpoint(manager=mgr,
                                                     save_steps=2),
                         CutAfterEpoch0()])
    saved = {k: v._data.detach().cpu().clone()
             for k, v in first.network.state_dict().items()}
    saved_step, saved_count = first._global_step, first._optimizer._step_count
    saved_moments = len(first._optimizer._accumulators)
    del first
    torch.cuda.empty_cache()

    seen = {}

    class AfterRestore(paddle.hapi.Callback):
        def on_train_begin(self, logs=None):
            m = self.model
            seen.update(
                global_step=m._global_step,
                step_count=m._optimizer._step_count,
                accumulators=len(m._optimizer._accumulators),
                unequal=_unequal(saved, {
                    k: v._data.detach().cpu()
                    for k, v in m.network.state_dict().items()}))

    resumed = build(32, names)
    history = resumed.fit(data, batch_size=FIT_BATCH, epochs=FIT_EPOCHS,
                          shuffle=True, num_workers=FIT_WORKERS, verbose=0,
                          resume=mgr, callbacks=[AfterRestore()])
    path = os.path.join(directory, "resnet50")
    resumed.save(path)
    loaded = build(33, names)
    loaded.load(path)
    unequal_load = _unequal(_flat_state(resumed.network, resumed._optimizer),
                            _flat_state(loaded.network, loaded._optimizer))
    with contextlib.redirect_stdout(StringIO()):
        info = paddle.summary(loaded.network, (1, 3, 224, 224))
        flops = paddle.flops(loaded.network, [1, 3, 224, 224])
    row = {"hapi": "resnet50 Model.fit(resume=...) fp32", "card": card,
           "saved_global_step": saved_step, "saved_step_count": saved_count,
           "restored": seen, "params": len(names), "history": history,
           "global_step_after": resumed._global_step,
           "checkpoint_bytes": os.path.getsize(mgr.latest()),
           "save_load_unequal": unequal_load[:10],
           "summary_params": info["total_params"], "flops": flops}
    log(json.dumps(row, default=float))
    checks = {
        "restored counters": (seen.get("global_step") == saved_step
                              == FIT_IMAGES // FIT_BATCH
                              and seen.get("step_count") == saved_count),
        "restored weights": seen.get("unequal") == [],
        "restored moments": seen.get("accumulators") == saved_moments
        == len(names),
        "resumed epochs": (len(history) == FIT_EPOCHS - 1
                           and all(np.isfinite(history))
                           and resumed._global_step == 2 * saved_step),
        "save_dir": os.path.exists(os.path.join(directory, "fit",
                                                "epoch_0.pdparams")),
        "save/load bitwise": unequal_load == [],
        "summary": info["total_params"] == RESNET50_PARAMS,
        "flops": flops == RESNET50_FLOPS_224,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"resnet50 hapi checkpoint: {failed}")


def phase_checkpoint(state):
    """Checkpoints and resume on the card: BERT-base's train state saved,
    resumed, corrupted and killed; hapi's ResNet-50 fit resumed. Runs K1-K3
    through the BERT steps; writes under a tempfile.mkdtemp() directory,
    deleted at the end."""
    import paddle_tpu_torch as paddle
    card = _card_line()
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.perf_counter()
    try:
        with paddle.device_guard("gpu:0"):
            _ckpt_bert(paddle, card, directory)
            torch.cuda.empty_cache()
            _ckpt_mttr(card, directory)
            _ckpt_hapi(paddle, card, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"checkpoint: {time.perf_counter() - t0:.1f} s")


# bench.py's ResNet-50 rung (_bench_resnet50, :240-285) and its small size
RESNET_RUNG = dict(b=256, hw=224, classes=1000, steps=10, warmup=2)
RESNET_TINY = dict(b=4, hw=64, classes=10)
RESNET_GRAD_TOL = 1e-3           # card vs CPU, each parameter norm-wise
# the card-vs-CPU AdamW steps' learning rate: at bench.py's 2.5e-4 Adam
# moves every weight by about lr a step, 1-2% of a conv weight, and batch
# norm over 16 values a channel amplifies the devices' 1e-5 rounding
# difference about thirtyfold a step (losses 1e-6, 4e-5, 1.4e-3 apart)
RESNET_PARITY_LR = 1e-5
RESNET_FWD_FLOP = 4.1e9          # bench.py:269: a 224x224 image's forward
# the JAX package's summary and flops of ResNet-50 at 1x3x224x224
# (tests/test_torch_summary_flops.py holds both packages to these)
RESNET50_PARAMS = 25_557_032
RESNET50_FLOPS_224 = 4_121_123_328
A100_IMAGES_PER_S = 2080         # bench.py:276: the A100 reference
A100_BF16_FLOP_PER_S = 312e12
FIT_IMAGES, FIT_BATCH, FIT_EPOCHS, FIT_WORKERS = 256, 64, 2, 2


def _resnet_batch(paddle, rng, b, hw, classes):
    return (paddle.to_tensor(rng.randn(b, 3, hw, hw).astype(np.float32)),
            paddle.to_tensor(rng.randint(0, classes, (b,)).astype(np.int64)))


def _resnet_tiny_parity(paddle):
    """fp32 ResNet-18 (10 classes, B=4, 64x64: bench.py's small ResNet
    size) on the card against a CPU twin with the same weights, TF32 off:
    train-mode logits within LOGITS_TOL; every parameter's gradient of
    one step norm-wise within RESNET_GRAD_TOL; three AdamW steps (at
    RESNET_PARITY_LR) losses and the running statistics after them within
    LOSS_TOL."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet18
    t = RESNET_TINY
    paddle.seed(21)
    card = resnet18(num_classes=t["classes"])
    state = {k: v.numpy() for k, v in card.state_dict().items()}
    with paddle.device_guard("cpu"):
        twin = resnet18(num_classes=t["classes"])
        twin.set_state_dict(state)
    batches = [(np.random.RandomState(60 + i).randn(
        t["b"], 3, t["hw"], t["hw"]).astype(np.float32),
        np.random.RandomState(70 + i).randint(0, t["classes"], t["b"]))
        for i in range(3)]
    logits, grads, losses, stats = [], [], [], []
    for model, dev in ((card, "gpu:0"), (twin, "cpu")):
        with paddle.device_guard(dev):
            model.train()
            x, y = (paddle.to_tensor(a) for a in batches[0])
            with paddle.no_grad():
                logits.append(model(x).numpy())
            F.cross_entropy(model(x), y).backward()
            grads.append([p.grad.numpy().astype(np.float64)
                          for p in model.parameters()])
            model.clear_gradients()
            opt = paddle.optimizer.AdamW(learning_rate=RESNET_PARITY_LR,
                                         parameters=model.parameters(),
                                         **ADAMW)
            run = []
            for x, y in batches:
                loss = F.cross_entropy(model(paddle.to_tensor(x)),
                                       paddle.to_tensor(y))
                loss.backward()
                opt.step()
                opt.clear_grad()
                run.append(float(loss.item()))
            losses.append(run)
            stats.append({k: v.numpy() for k, v in model.named_buffers()})
    err = float(np.abs(logits[0] - logits[1]).max())
    grad_err = max(float(np.linalg.norm(g - c) / max(np.linalg.norm(c),
                                                     1e-30))
                   for g, c in zip(*grads))
    loss_err = max(abs(a - c) for a, c in zip(*losses))
    stat_err = max(float(np.abs(stats[0][k] - stats[1][k]).max())
                   for k in stats[1])
    log(f"vision: tiny ResNet-18 fp32 card vs CPU: logits max abs err "
        f"{err:.3e} (limit {LOGITS_TOL}); gradients norm-wise {grad_err:.3e} "
        f"(limit {RESNET_GRAD_TOL}); losses {losses[0]} vs {losses[1]}, max "
        f"err {loss_err:.3e}; running statistics max err {stat_err:.3e} "
        f"(limit {LOSS_TOL})")
    if not (err <= LOGITS_TOL and grad_err <= RESNET_GRAD_TOL
            and loss_err <= LOSS_TOL and stat_err <= LOSS_TOL):
        raise AssertionError("tiny ResNet-18: the card disagrees with its "
                             "CPU twin")


def _resnet_step(model, opt, x, y, events=None, amp_kw=O1):
    """One eager step of bench.py's loop: forward and loss under
    ``amp.auto_cast``, backward, AdamW; no kernel of the port launches."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    c0 = _counts()
    if events:
        events[0].record()
    with amp.auto_cast(**amp_kw):
        loss = F.cross_entropy(model(x), y)
    if events:
        events[1].record()
    loss.backward()
    if events:
        events[2].record()
    opt.step()
    opt.clear_grad()
    if events:
        events[3].record()
    if _launched(c0, _counts()):
        raise AssertionError("a ResNet step launched a kernel of the port")
    return loss


def _resnet50_rung(paddle, card, profile):
    """bench.py's ResNet-50 rung: B=256, 224x224, 1000 classes, fp32 live
    weights (bf16_weights=False), AdamW (b1 0.9, b2 0.95, eps 1e-8, wd 0.1
    on every parameter, lr 2.5e-4), O1 bf16; batches from RandomState(i),
    all made before timing; RESNET_RUNG["warmup"] steps, then
    RESNET_RUNG["steps"] timed. One JSON line in the rung format. The
    losses must be finite and the first timed batch's loss, again after
    the timed steps, below its first."""
    from paddle_tpu_torch.vision.models import resnet50
    r = RESNET_RUNG
    paddle.seed(22)
    model = resnet50(num_classes=r["classes"])
    model.train()
    n_params = sum(p.size for p in model.parameters())
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters(), **ADAMW)
    batches = [_resnet_batch(paddle, np.random.RandomState(i), r["b"],
                             r["hw"], r["classes"])
               for i in range(r["warmup"] + r["steps"])]
    for x, y in batches[:r["warmup"]]:
        _resnet_step(model, opt, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, split, losses = [], [], []
    for x, y in batches[r["warmup"]:]:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _resnet_step(model, opt, x, y, events)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        split.append([events[j].elapsed_time(events[j + 1])
                      for j in range(3)])
        losses.append(float(loss.item()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    # each step's batch is new, with random labels: the loss learned
    # shows on the first timed batch again (bench.py's rung itself ends
    # above its first loss on fresh batches)
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    x0, y0 = batches[r["warmup"]]
    # batch norm's input elements in a step: each is kept as an fp32
    # copy for the backward (the port casts it, as the JAX package does)
    bn_elems = []
    hooks = [layer.register_forward_pre_hook(
        lambda layer, inputs: bn_elems.append(inputs[0].size))
        for layer in model.sublayers()
        if isinstance(layer, paddle.nn.BatchNorm2D)]
    with paddle.no_grad(), amp.auto_cast(**O1):
        again = float(F.cross_entropy(model(x0), y0).item())
    for h in hooks:
        h.remove()
    bn_fp32_gb = 4 * sum(bn_elems) / 1e9
    q1, median, q3 = statistics.quantiles(walls, n=4)
    fwd, bwd, upd = (statistics.median(x[j] for x in split)
                     for j in range(3))
    images_per_s = r["b"] / median
    flops_per_image = 3 * RESNET_FWD_FLOP
    mfu = flops_per_image * images_per_s / BF16_FLOP_PER_S
    a100_util = A100_IMAGES_PER_S * flops_per_image / A100_BF16_FLOP_PER_S
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    row = {"metric": "resnet50_train_images_per_sec_per_chip",
           "value": images_per_s, "unit": "images/s",
           "vs_baseline": mfu / a100_util,
           "extra": {"rung": f"resnet50 O1 bf16 fp32-weights B{r['b']} "
                             f"{r['hw']}x{r['hw']}",
                     "card": card, "params": n_params, "batch": r["b"],
                     "steps": len(losses), "step_ms": median * 1e3,
                     "step_ms_q1": q1 * 1e3, "step_ms_q3": q3 * 1e3,
                     "forward_ms": fwd, "backward_ms": bwd,
                     "optimizer_ms": upd, "mfu": mfu,
                     "a100_ref_util": a100_util, "peak_memory_gb": peak,
                     "card_memory_gb": card_gb,
                     "bn_fp32_inputs_gb": bn_fp32_gb,
                     "bn_layers": len(bn_elems), "loss_first": losses[0],
                     "loss_last": losses[-1], "losses": losses,
                     "loss_batch0_again": again,
                     "switches": dict(amp="O1 bfloat16", bf16_weights=False,
                                      layout="NCHW",
                                      cudnn_benchmark=torch.backends.cudnn
                                      .benchmark)}}
    if profile:
        x, y = batches[-1]
        prof = _profile(
            "resnet50 rung step",
            lambda: _resnet_step(model, opt, x, y),
            groups={"layout transposes (kernels)": ("nchwtonhwc",
                                                     "nhwctonchw")},
            op_groups={"convolutions (cuDNN)": (
                           "aten::cudnn_convolution",
                           "aten::convolution_backward"),
                       "batch norm": ("aten::cudnn_batch_norm",
                                      "aten::cudnn_batch_norm_backward"),
                       "copies (O1 casts)": ("aten::copy_",),
                       "relu": ("aten::clamp_min",
                                "aten::threshold_backward"),
                       "residual adds": ("aten::add", "aten::add_"),
                       "pools": ("aten::max_pool2d_with_indices",
                                 "aten::max_pool2d_with_indices_backward",
                                 "aten::mean",
                                 "aten::_adaptive_avg_pool2d",
                                 "aten::_adaptive_avg_pool2d_backward"),
                       "fc GEMM": ("aten::addmm", "aten::mm"),
                       "optimizer (foreach)": (
                           "aten::_foreach_mul_", "aten::_foreach_add_",
                           "aten::_foreach_addcmul_", "aten::_foreach_div",
                           "aten::_foreach_sqrt_",
                           "aten::_foreach_addcdiv_")})
        row["extra"]["profiled_device_ms"] = prof["device_busy_s"] * 1e3
        row["extra"]["device_busy_share"] = prof["device_busy_share"]
    log(json.dumps(row))
    if not (all(np.isfinite(losses + [again])) and again < losses[0]):
        raise AssertionError(f"resnet50 rung: losses {losses}, the first "
                             f"batch again {again}")
    if not peak < card_gb:
        raise AssertionError(f"resnet50 rung: peak {peak} GB")
    del model, opt, batches
    return images_per_s


class _ImageSet:
    """A numpy-seeded in-memory dataset of 3x224x224 images and labels."""

    def __init__(self, n, hw, classes, seed):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 3, hw, hw).astype(np.float32)
        self.y = rng.randint(0, classes, n).astype(np.int64)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _resnet50_fit(paddle, card, rung_images_per_s):
    """hapi Model.fit on ResNet-50 at full width, fp32 (as the JAX Model
    runs it): FIT_IMAGES images, batch FIT_BATCH, FIT_EPOCHS epochs,
    shuffled, FIT_WORKERS forked workers, prefetch on, Accuracy(topk=(1,
    5)), EarlyStopping and LRScheduler; then evaluate and predict. Gates:
    finite history, the goodput ledger's steps, every batch on the card
    through the prefetcher, no worker left, predict's shape."""
    import multiprocessing as mp

    from paddle_tpu_torch.io import prefetch
    from paddle_tpu_torch.observability import goodput, sentinel, trace
    from paddle_tpu_torch.vision.models import resnet50
    paddle.set_flags({"FLAGS_prefetch": True})
    paddle.seed(23)
    net = resnet50(num_classes=RESNET_RUNG["classes"])
    sched = paddle.optimizer.lr.StepDecay(LR, step_size=4, gamma=0.5)
    opt = paddle.optimizer.AdamW(learning_rate=sched,
                                 parameters=net.parameters(), **ADAMW)
    model = paddle.Model(net)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  paddle.metric.Accuracy(topk=(1, 5)))
    data = _ImageSet(FIT_IMAGES, RESNET_RUNG["hw"], RESNET_RUNG["classes"],
                     seed=24)
    on_card, step_walls = [], []
    train_batch = model.train_batch

    def watched(inputs, labels=None, update=True):
        on_card.append(all(t._data.is_cuda for t in inputs + labels))
        t0 = time.perf_counter()
        out = train_batch(inputs, labels, update)    # ends on a host read
        step_walls.append(time.perf_counter() - t0)
        return out
    model.train_batch = watched
    epoch_walls = []

    class EpochClock(paddle.hapi.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_epoch_end(self, epoch, logs=None):
            torch.cuda.synchronize()
            epoch_walls.append(time.perf_counter() - self.t0)
    goodput.reset_ledger()
    sentinel.reset()
    before = prefetch.transfer_counts()
    trace.clear()
    trace.activate()             # the producer's io.prefetch spans
    t0 = time.perf_counter()
    history = model.fit(data, batch_size=FIT_BATCH, epochs=FIT_EPOCHS,
                        shuffle=True, num_workers=FIT_WORKERS, verbose=0,
                        callbacks=[EpochClock(),
                                   paddle.hapi.EarlyStopping(monitor="loss"),
                                   paddle.hapi.LRScheduler(by_step=True)])
    fit_s = time.perf_counter() - t0
    trace.deactivate()
    produce = [t1 - t0 for name, _, t0, t1, _, _ in trace.drain()
               if name == "io.prefetch"]
    alive = mp.active_children()
    snap = goodput.ledger().snapshot()
    goodput.ledger().run_end()
    after = prefetch.transfer_counts()
    steps = FIT_EPOCHS * FIT_IMAGES // FIT_BATCH
    # the same model's train_batch on batches already on the card: the
    # loader and prefetcher's cost is the difference
    x, y = (paddle.to_tensor(data.x[:FIT_BATCH]),
            paddle.to_tensor(data.y[:FIT_BATCH]))
    train_batch([x], [y])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(4):
        train_batch([x], [y])
    torch.cuda.synchronize()
    resident_s = (time.perf_counter() - t1) / 4
    resident_images_per_s = FIT_BATCH / resident_s
    result = model.evaluate(data, batch_size=FIT_BATCH, verbose=0)
    preds = model.predict(data, batch_size=FIT_BATCH, stack_outputs=True)
    row = {"fit": "resnet50 hapi Model.fit fp32 224x224", "card": card,
           "images": FIT_IMAGES, "batch": FIT_BATCH, "epochs": FIT_EPOCHS,
           "num_workers": FIT_WORKERS, "history": history,
           "fit_s": fit_s, "epoch_s": epoch_walls,
           "fit_images_per_s_epoch2": FIT_IMAGES / epoch_walls[-1],
           "train_batch_resident_images_per_s": resident_images_per_s,
           "train_batch_ms_in_fit": [w * 1e3 for w in step_walls],
           "train_batch_ms_resident": resident_s * 1e3,
           "producer_ms_a_batch": [p * 1e3 for p in produce],
           "rung_images_per_s_o1": rung_images_per_s,
           "goodput_steps": snap["steps"],
           "goodput_buckets_s": snap["buckets"],
           "sentinel": sentinel.get().counts(),
           "prefetched_batches": after["batches"] - before["batches"],
           "host_to_device_copies": (after["host_to_device"]
                                     - before["host_to_device"]),
           "batches_on_card": sum(on_card), "workers_alive": len(alive),
           "lr_after": sched(), "evaluate": result,
           "predict_shape": list(preds[0].shape)}
    log(json.dumps(row, default=float))
    checks = {
        "history": len(history) == FIT_EPOCHS and all(
            np.isfinite(history)),
        "goodput steps": snap["steps"] == steps,
        "batches through the prefetcher": (
            row["prefetched_batches"] == steps and all(on_card)
            and len(on_card) == steps
            and row["host_to_device_copies"] == 2 * steps),
        "no worker alive": not alive,
        "scheduler stepped": sched.last_epoch == steps,
        "predict": row["predict_shape"] == [FIT_IMAGES,
                                            RESNET_RUNG["classes"]],
        "evaluate": np.isfinite(result["loss"][0]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"resnet50 fit: {failed}")


def phase_vision(state):
    """Image classification in the Paddle API: a tiny ResNet-18 against
    its CPU twin, bench.py's ResNet-50 rung, and hapi Model.fit on
    ResNet-50. No kernel of the port runs here (convolutions and pools
    are cuDNN's and torch's, as the JAX package's are XLA's)."""
    import paddle_tpu_torch as paddle
    card = _card_line()
    t0 = time.perf_counter()
    with paddle.device_guard("gpu:0"):
        _resnet_tiny_parity(paddle)
        torch.cuda.empty_cache()
        images_per_s = _resnet50_rung(paddle, card, state.get("profile"))
        torch.cuda.empty_cache()
        _resnet50_fit(paddle, card, images_per_s)
    torch.cuda.empty_cache()
    log(f"vision: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- vision_zoo
# the rest of paddle.vision at published widths: every new constructor of
# the zoo (1000 classes, scale 1.0), 224x224 (InceptionV3 299x299), B2
ZOO_CTORS = (
    ("vgg11", {}), ("vgg11", {"batch_norm": True}), ("vgg13", {}),
    ("vgg13", {"batch_norm": True}), ("vgg16", {}),
    ("vgg16", {"batch_norm": True}), ("vgg19", {}),
    ("vgg19", {"batch_norm": True}), ("mobilenet_v1", {}),
    ("mobilenet_v2", {}), ("mobilenet_v3_small", {}),
    ("mobilenet_v3_large", {}), ("alexnet", {}), ("squeezenet1_0", {}),
    ("squeezenet1_1", {}), ("shufflenet_v2_x0_25", {}),
    ("shufflenet_v2_x0_33", {}), ("shufflenet_v2_x0_5", {}),
    ("shufflenet_v2_x1_0", {}), ("shufflenet_v2_x1_5", {}),
    ("shufflenet_v2_x2_0", {}), ("shufflenet_v2_swish", {}),
    ("densenet121", {}), ("densenet161", {}), ("densenet169", {}),
    ("densenet201", {}), ("densenet264", {}), ("googlenet", {}),
    ("inception_v3", {}))
ZOO_TRAIN = ("mobilenet_v2", "mobilenet_v3_large", "googlenet")
ZOO_B = 2
# a batch-norm bias that feeds a convolution and another train-mode batch
# norm has a zero gradient in exact arithmetic: its rounding noise is held
# against this share of the largest gradient's norm, not its own
ZOO_GRAD_FLOOR = 1e-3
# the train steps' gradients, card vs CPU, each parameter norm-wise: at B2
# the last blocks' batch norms normalize 98 values a channel, and fp32
# itself is far from exact there. An fp32 CPU step is up to 1.1e-2
# (MobileNetV2), 1.1e-4 (MobileNetV3-Large) and 2.8e-2 (GoogLeNet) from a
# float64 step on the same weights (tests/torch_zoo_float64.py); the card
# carries the same rounding, so two fp32 devices may differ by twice that
ZOO_GRAD_TOL = 1e-1
# the main path: MobileNetV2 trained through hapi Model.fit over a
# DatasetFolder of .npy images, Paddle's ImageNet recipe (Momentum 0.9,
# L2Decay(4e-5), cosine decay) at a batch of 256, amp O1 bf16
MBV2_FIT = dict(images=1280, hw=256, crop=224, classes=10, batch=256,
                workers=4, epochs=2, lr=0.1, weight_decay=4e-5)
MBV2_MEAN = [123.675, 116.28, 103.53]
MBV2_STD = [58.395, 57.12, 57.375]
MBV2_FWD_FLOP = 0.60e9      # 300M multiply-adds an image at 224x224
MBV2_BARE_STEPS = 8
# detection ops at Faster R-CNN / YOLOv3 sizes: a (2, 256, 200, 336)
# stride-4 level of an 800x1344 image and 1000 RoIs, 2000 proposals for
# NMS, a 64x64 DCN layer, a 19x19 YOLOv3 head
DET_LEVEL = (2, 256, 200, 336)
DET_IMAGE = (800, 1344)
DET_ROIS = 1000
DET_NMS = 2000
DET_DCN = (2, 256, 64, 64)
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]


def _zoo_heads(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _zoo_no_dropout(model):
    for layer in model.sublayers():
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0


def _zoo_pair(paddle, name, kw, seed):
    """A zoo model on the card and its CPU twin with the same weights."""
    from paddle_tpu_torch.vision import models
    paddle.seed(seed)
    card = getattr(models, name)(num_classes=1000, **kw)
    state = {k: v.numpy() for k, v in card.state_dict().items()}
    with paddle.device_guard("cpu"):
        twin = getattr(models, name)(num_classes=1000, **kw)
        twin.set_state_dict(state)
    return card, twin


def _zoo_rel(a, b):
    """max |a - b| over the larger of 1 and max |b|."""
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _zoo_parity(paddle):
    """Every new constructor's eval forward on the card against its CPU
    twin (max error over max(1, |logits|) within LOGITS_TOL); for
    ZOO_TRAIN also one train-mode step (dropout off on both sides): the
    loss within LOSS_TOL and each gradient norm-wise within ZOO_GRAD_TOL
    of the larger of its norm and ZOO_GRAD_FLOOR of the largest."""
    from paddle_tpu_torch.nn import functional as F
    worst = {}
    for i, (name, kw) in enumerate(ZOO_CTORS):
        label = name + ("_bn" if kw.get("batch_norm") else "")
        card, twin = _zoo_pair(paddle, name, kw, 31 + i)
        hw = 299 if name == "inception_v3" else 224
        x = np.random.RandomState(40 + i).randn(ZOO_B, 3, hw, hw).astype(
            np.float32)
        outs = []
        for model, dev in ((card, "gpu:0"), (twin, "cpu")):
            with paddle.device_guard(dev), paddle.no_grad():
                model.eval()
                outs.append([h.numpy() for h in
                             _zoo_heads(model(paddle.to_tensor(x)))])
        err = max(_zoo_rel(a, b) for a, b in zip(*outs))
        worst[label] = err
        if not (err <= LOGITS_TOL and all(
                np.isfinite(h).all() and h.shape == (ZOO_B, 1000)
                for h in outs[0])):
            raise AssertionError(f"vision_zoo {label}: eval logits card vs "
                                 f"CPU {err:.3e}")
        if name in ZOO_TRAIN:
            y = np.random.RandomState(50 + i).randint(0, 1000, ZOO_B)
            got = []
            for model, dev in ((card, "gpu:0"), (twin, "cpu")):
                _zoo_no_dropout(model)
                with paddle.device_guard(dev):
                    model.train()
                    heads = _zoo_heads(model(paddle.to_tensor(x)))
                    lab = paddle.to_tensor(y)
                    loss = F.cross_entropy(heads[0], lab)
                    for aux in heads[1:]:
                        loss = loss + 0.3 * F.cross_entropy(aux, lab)
                    loss.backward()
                    got.append((float(loss.item()),
                                [p.grad.numpy().astype(np.float64)
                                 for p in model.parameters()]))
            (l_card, g_card), (l_cpu, g_cpu) = got
            largest = max(np.linalg.norm(g) for g in g_cpu)
            errs = sorted(
                (float(np.linalg.norm(a - b)
                       / max(np.linalg.norm(b), ZOO_GRAD_FLOOR * largest)),
                 pname)
                for (pname, _), a, b in zip(twin.named_parameters(), g_card,
                                            g_cpu))
            grad_err = errs[-1][0]
            log(f"vision_zoo: {label} train step card vs CPU: loss "
                f"{l_card:.6f} vs {l_cpu:.6f}, gradients {grad_err:.3e} "
                f"(limits {LOSS_TOL}, {ZOO_GRAD_TOL}); worst "
                f"{errs[-3:][::-1]}")
            if not (abs(l_card - l_cpu) <= LOSS_TOL
                    and grad_err <= ZOO_GRAD_TOL):
                raise AssertionError(f"vision_zoo {label}: the train step "
                                     f"disagrees with the CPU twin")
        del card, twin
        torch.cuda.empty_cache()
    log(json.dumps({"vision_zoo_eval_parity": worst,
                    "limit": LOGITS_TOL}))


def _npy_folder(root, f):
    """f["images"] seeded uint8 HWC images as .npy files in
    f["classes"] class folders."""
    rng = np.random.RandomState(60)
    for i in range(f["images"]):
        d = os.path.join(root, f"class_{i % f['classes']:02d}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{i:05d}.npy"), rng.randint(
            0, 256, (f["hw"], f["hw"], 3), dtype=np.uint8))


def _mbv2_fit(paddle, card):
    """The main path: MobileNetV2 (scale 1.0, 1000 classes) trained by
    hapi Model.fit over a DatasetFolder of MBV2_FIT["images"] .npy
    images through RandomCrop, RandomHorizontalFlip, Normalize (HWC) and
    Transpose, B256 with forked workers and the prefetcher, Momentum with
    L2Decay under CosineAnnealingDecay, amp O1 bf16; then evaluate and
    predict, and a bare train_batch loop on one resident batch. Gates:
    finite history, every batch on the card, no worker left, predict's
    shape."""
    import multiprocessing as mp

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.io import prefetch
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision import datasets, transforms as T
    from paddle_tpu_torch.vision.models import mobilenet_v2
    f = MBV2_FIT
    root = tempfile.mkdtemp(prefix="vision_zoo_")
    try:
        t0 = time.perf_counter()
        _npy_folder(root, f)
        write_s = time.perf_counter() - t0
        tr = T.Compose([T.RandomCrop(f["crop"]), T.RandomHorizontalFlip(),
                        T.Normalize(mean=MBV2_MEAN, std=MBV2_STD,
                                    data_format="HWC"), T.Transpose()])
        data = datasets.DatasetFolder(root, loader=np.load,
                                      extensions=(".npy",), transform=tr)
        paddle.set_flags({"FLAGS_prefetch": True})
        paddle.seed(61)
        net = mobilenet_v2(num_classes=1000)
        steps = f["epochs"] * -(-f["images"] // f["batch"])
        sched = paddle.optimizer.lr.CosineAnnealingDecay(f["lr"],
                                                         T_max=steps)
        opt = paddle.optimizer.Momentum(
            learning_rate=sched, momentum=0.9,
            parameters=net.parameters(),
            weight_decay=L2Decay(f["weight_decay"]))
        model = paddle.Model(net)
        model.prepare(opt, paddle.nn.CrossEntropyLoss())
        on_card, walls, device_ms = [], [], []
        train_batch = model.train_batch

        def watched(inputs, labels=None, update=True):
            on_card.append(all(t._data.is_cuda for t in inputs + labels))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t1 = time.perf_counter()
            ev[0].record()
            out = train_batch(inputs, labels, update)   # ends on a host read
            ev[1].record()
            walls.append(time.perf_counter() - t1)
            ev[1].synchronize()
            device_ms.append(ev[0].elapsed_time(ev[1]))
            return out
        model.train_batch = watched
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = prefetch.transfer_counts()
        t0 = time.perf_counter()
        with amp.auto_cast(**O1):
            history = model.fit(data, batch_size=f["batch"],
                                epochs=f["epochs"], shuffle=True,
                                num_workers=f["workers"], verbose=0,
                                callbacks=[paddle.hapi.LRScheduler(
                                    by_step=True)])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        alive = mp.active_children()
        after = prefetch.transfer_counts()
        # the bare loop: train_batch on one batch already on the card
        x = np.stack([data[i][0] for i in range(f["batch"])])
        y = np.asarray([data[i][1] for i in range(f["batch"])])
        xb, yb = paddle.to_tensor(x), paddle.to_tensor(y)
        bare, bare_dev = [], []
        with amp.auto_cast(**O1):
            train_batch([xb], [yb])
            for _ in range(MBV2_BARE_STEPS):
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ev[0].record()
                train_batch([xb], [yb])
                ev[1].record()
                torch.cuda.synchronize()
                bare.append(time.perf_counter() - t1)
                bare_dev.append(ev[0].elapsed_time(ev[1]))
            result = model.evaluate(data, batch_size=f["batch"], verbose=0)
            preds = model.predict(data, batch_size=f["batch"],
                                  stack_outputs=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    step_ms = statistics.median(bare) * 1e3
    bare_ips = f["batch"] / statistics.median(bare)
    fit_ips = f["images"] * f["epochs"] / fit_s
    row = {"vision_zoo_fit": "mobilenet_v2 scale 1.0 hapi Model.fit amp "
                             "O1 bf16 Momentum L2Decay cosine",
           "card": card, "images": f["images"], "batch": f["batch"],
           "epochs": f["epochs"], "num_workers": f["workers"],
           "write_s": write_s, "history": history, "fit_s": fit_s,
           "fit_images_per_s": fit_ips,
           "train_batch_ms_in_fit": [w * 1e3 for w in walls],
           "train_batch_device_ms_in_fit": device_ms,
           "bare_train_batch_images_per_s": bare_ips,
           "bare_step_ms": step_ms,
           "bare_step_ms_all": [w * 1e3 for w in bare],
           "bare_step_device_ms": statistics.median(bare_dev),
           "mfu": 3 * MBV2_FWD_FLOP * bare_ips / BF16_FLOP_PER_S,
           "mfu_fit": 3 * MBV2_FWD_FLOP * fit_ips / BF16_FLOP_PER_S,
           "peak_memory_gb": peak, "lr_after": sched(),
           "prefetched_batches": after["batches"] - before["batches"],
           "batches_on_card": sum(on_card), "workers_alive": len(alive),
           "evaluate": result, "predict_shape": list(preds[0].shape)}
    log(json.dumps(row, default=float))
    checks = {
        "history": len(history) == f["epochs"] and all(
            np.isfinite(history)),
        "every batch on the card": (all(on_card) and len(on_card) == steps
                                    and row["prefetched_batches"] == steps),
        "no worker alive": not alive,
        "predict": row["predict_shape"] == [f["images"], 1000],
        "evaluate": np.isfinite(result["loss"][0]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"vision_zoo fit: {failed}")


def _det_boxes(rng, n, image, lo, hi):
    """n xyxy boxes inside ``image`` (h, w), sides in [lo, hi)."""
    h, w = image
    wh = lo + rng.rand(n, 2) * (hi - lo)
    xy = rng.rand(n, 2) * (np.array([w, h]) - wh)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _det_case(paddle, label, fn, arrays, diff, rows, compare_ints=False):
    """fn(*tensors) on the card and on the CPU from the same arrays:
    outputs within FP32_TOL (relative to max(1, |ref|)), and for the
    inputs flagged in ``diff`` the gradients of sum(out * w) norm-wise
    within FP32_TOL; the card's ms (time_ms: the time a caller waits)."""
    res = []
    for dev in ("gpu:0", "cpu"):
        with paddle.device_guard(dev):
            ts = [paddle.to_tensor(a, stop_gradient=not d)
                  for a, d in zip(arrays, diff)]
            outs = _zoo_heads(fn(*ts))
            if any(diff):
                loss = None
                for k, o in enumerate(outs):
                    w = paddle.to_tensor(np.random.RandomState(70 + k).randn(
                        *o.shape).astype(np.float32))
                    term = (o * w).sum()
                    loss = term if loss is None else loss + term
                loss.backward()
            res.append(([o.numpy() for o in outs],
                        [t.grad.numpy().astype(np.float64)
                         for t, d in zip(ts, diff) if d]))
    (o_card, g_card), (o_cpu, g_cpu) = res
    err = 0.0
    for a, b in zip(o_card, o_cpu):
        if a.shape != b.shape:
            raise AssertionError(f"vision_zoo {label}: shapes {a.shape} "
                                 f"vs {b.shape}")
        if np.issubdtype(b.dtype, np.integer) or compare_ints:
            if not np.array_equal(a, b):
                raise AssertionError(f"vision_zoo {label}: indices differ")
        else:
            err = max(err, _zoo_rel(a, b))
    grad_err = max([float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                      1e-30))
                    for a, b in zip(g_card, g_cpu)], default=0.0)
    with paddle.device_guard("gpu:0"):
        ts = [paddle.to_tensor(a) for a in arrays]
        ms = time_ms(lambda: fn(*ts), iters=10, warmup=2)
    rows.append({"op": label, "ms": ms[0], "ms_q1": ms[1], "ms_q3": ms[2],
                 "max_rel_err": err, "grad_norm_err": grad_err,
                 "out_shapes": [list(a.shape) for a in o_card]})
    if not (err <= FP32_TOL and grad_err <= FP32_TOL):
        raise AssertionError(f"vision_zoo {label}: card vs CPU {err:.3e}, "
                             f"gradients {grad_err:.3e}")


def _det_ops(paddle, card):
    """The detection ops on the card against the same call on the CPU, at
    Faster R-CNN / YOLOv3 sizes; one JSON line of their card ms."""
    from paddle_tpu_torch.vision import ops as V
    rng = np.random.RandomState(80)
    rows = []
    feat = rng.randn(*DET_LEVEL).astype(np.float32)
    rois = _det_boxes(rng, DET_ROIS, DET_IMAGE, 16, 112)
    num = np.array([DET_ROIS // 2, DET_ROIS - DET_ROIS // 2])
    _det_case(paddle, "roi_align 7x7 sr2 (2,256,200,336) x1000",
              lambda x, b: V.roi_align(x, b, num, 7, spatial_scale=0.25,
                                       sampling_ratio=2),
              [feat, rois], [True, False], rows)
    _det_case(paddle, "roi_pool 7x7 (2,256,200,336) x1000",
              lambda x, b: V.roi_pool(x, b, num, 7, spatial_scale=0.25),
              [feat, rois], [True, False], rows)
    del feat
    boxes = _det_boxes(rng, DET_NMS, DET_IMAGE, 16, 200)
    scores = (rng.permutation(DET_NMS).astype(np.float32) + 1) / DET_NMS
    _det_case(paddle, f"nms {DET_NMS} boxes at 0.7",
              lambda b, s: V.nms(b, 0.7, s), [boxes, scores],
              [False, False], rows, compare_ints=True)
    n, c, h, w = DET_DCN
    dcn = [rng.randn(n, c, h, w).astype(np.float32),
           (2.0 * rng.randn(n, 18, h, w)).astype(np.float32),
           (rng.randn(c, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32),
           rng.rand(n, 9, h, w).astype(np.float32),
           rng.randn(c).astype(np.float32)]
    _det_case(paddle, "deform_conv2d v2 3x3 (2,256,64,64)",
              lambda x, o, wt, m, b: V.deform_conv2d(x, o, wt, bias=b,
                                                     padding=1, mask=m),
              dcn, [True] * 5, rows)
    head = (0.5 * rng.randn(2, 255, 19, 19)).astype(np.float32)
    img = np.array([[608, 608], [608, 608]], np.int32)
    _det_case(paddle, "yolo_box (2,255,19,19)",
              lambda x: V.yolo_box(x, paddle.to_tensor(img),
                                   YOLO_ANCHORS[12:], 80, 0.01, 32),
              [head], [True], rows)
    gt = np.zeros((2, 50, 4), np.float32)
    gt[:, :20, :2] = rng.rand(2, 20, 2) * 0.8 + 0.1
    gt[:, :20, 2:] = rng.rand(2, 20, 2) * 0.5 + 0.05
    gl = rng.randint(0, 80, (2, 50))
    _det_case(paddle, "yolo_loss (2,255,19,19) 20 boxes an image",
              lambda x: V.yolo_loss(x, paddle.to_tensor(gt),
                                    paddle.to_tensor(gl), YOLO_ANCHORS,
                                    [6, 7, 8], 80, 0.7, 32),
              [head], [True], rows)
    a, fh, fw = 15, 50, 84              # the stride-16 RPN level
    sc = rng.rand(2, a, fh, fw).astype(np.float32)
    deltas = (0.1 * rng.randn(2, 4 * a, fh, fw)).astype(np.float32)
    cy, cx = np.meshgrid(np.arange(fh) * 16 + 8, np.arange(fw) * 16 + 8,
                         indexing="ij")
    anchors = np.stack([np.stack([cx - s * r / 2, cy - s / r / 2,
                                  cx + s * r / 2, cy + s / r / 2], -1)
                        for s in (32, 64, 128, 256, 512)
                        for r in (0.7, 1.0, 1.4)], 2).astype(np.float32)
    var = np.ones_like(anchors)
    ims = np.array([DET_IMAGE, DET_IMAGE], np.float32)
    _det_case(paddle, "generate_proposals 6000 -> 1000 at 0.7",
              lambda s, d, an, v: V.generate_proposals(
                  s, d, paddle.to_tensor(ims), an, v, pre_nms_top_n=6000,
                  post_nms_top_n=1000, nms_thresh=0.7, min_size=0.0),
              [sc, deltas, anchors, var], [False] * 4, rows)
    prior = _det_boxes(rng, DET_ROIS, DET_IMAGE, 16, 256)
    target = (0.2 * rng.randn(DET_ROIS, 81, 4)).astype(np.float32)
    pvar = np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], np.float32),
                   (DET_ROIS, 1))
    _det_case(paddle, "box_coder decode 1000 x 81",
              lambda pb, v, t: V.box_coder(pb, v, t, "decode_center_size",
                                           box_normalized=False),
              [prior, pvar, target], [False] * 3, rows)
    _det_case(paddle, "box_coder encode 100 x 1000",
              lambda pb, t: V.box_coder(pb, None, t, "encode_center_size"),
              [prior, prior[:100] + 3.0], [False] * 2, rows)
    _det_case(paddle, "prior_box SSD 38x38 on 300x300",
              lambda x, im: V.prior_box(x, im, [30.0], [60.0], (2.0,),
                                        flip=True, clip=True),
              [np.zeros((1, 512, 38, 38), np.float32),
               np.zeros((1, 3, 300, 300), np.float32)], [False] * 2, rows)
    log(json.dumps({"vision_ops": rows, "card": card}, default=float))


def phase_vision_zoo(state):
    """The rest of paddle.vision: every new zoo constructor at its
    published width on the card against its CPU twin (three of them
    through a train step), the main path (MobileNetV2 trained by hapi
    Model.fit over a DatasetFolder with transforms, forked workers and
    the prefetcher), and the detection ops against their CPU results. No
    kernel of the port runs here (convolutions are cuDNN's; the JAX
    package's zoo and ops are XLA and jnp)."""
    import paddle_tpu_torch as paddle
    card = _card_line()
    try:
        import PIL
        pil = f"PIL {PIL.__version__} importable"
    except ImportError:
        pil = "PIL not importable"
    log(f"vision_zoo: {pil} (no phase needs it)")
    t0 = time.perf_counter()
    with paddle.device_guard("gpu:0"):
        _zoo_parity(paddle)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        _mbv2_fit(paddle, card)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        _det_ops(paddle, card)
    torch.cuda.empty_cache()
    log(f"vision_zoo: {time.perf_counter() - t0:.1f} s (zoo parity "
        f"{t1 - t0:.1f} s, fit {t2 - t1:.1f} s, detection ops "
        f"{time.perf_counter() - t2:.1f} s)")


# ----------------------------------------------------------------- deploy
# bench.py _bench_bert's widths (BERT-base; the unpadded vocabulary, as a
# two-class sequence classifier has no MLM head to pad for), served from
# its jit.save artifact
DEPLOY_BERT = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072,
                   max_position_embeddings=512, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
DEPLOY_SHAPES = ((1, 128), (1, 512), (8, 128), (8, 512), (48, 128),
                 (48, 512))
DEPLOY_CHECK = (8, 128)     # the fresh process's, the twin's and PTQ's batch
DEPLOY_RUNS = 20
DEPLOY_ROUNDS = 5           # the timed legs take turns, DEPLOY_RUNS each
DEPLOY_CHILD_TIMEOUT = 300
PTQ_BYTES = 0.45            # tests/test_round5.py:406
ONNX_HW = 224
_DEPLOY_CHILD = ("import sys, time; t0 = time.time(); "
                 "sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                 "chip_smoke._deploy_child(sys.argv[2], sys.argv[3], "
                 "sys.argv[4], t0)")


def _deploy_inputs(b, s):
    rng = np.random.RandomState(b * 1000 + s)
    return (rng.randint(0, DEPLOY_BERT["vocab_size"], (b, s)).astype(
        np.int64), rng.randint(0, 2, (b, s)).astype(np.int64))


def _predict(pred, ids, tt):
    """One ``Predictor.run`` on host arrays: (logits, its launches)."""
    names = pred.get_input_names()
    pred.get_input_handle(names[0]).copy_from_cpu(ids)
    pred.get_input_handle(names[1]).copy_from_cpu(tt)
    before = _counts()
    pred.run()
    launched = _launched(before, _counts())
    return pred.get_output_handle("output_0").copy_to_cpu(), launched


def _hold_k1(label, launched, layers):
    if launched != {"flash_attention_fwd": layers}:
        raise AssertionError(f"deploy {label}: launched {launched}, want "
                             f"flash_attention_fwd {layers} and no other")


def _uncounted(fn):
    """``fn()`` with the launch counts restored after it: a comparison
    with the eager model, not the served path."""
    counts = _counts()
    try:
        return fn()
    finally:
        for name, n in counts.items():
            _wrapper(name).launches = n


def _legs_ms(legs, uncounted=(), runs=DEPLOY_RUNS, rounds=DEPLOY_ROUNDS,
             warmup=2):
    """Host time of each ``legs[name]()`` followed by a synchronize, in
    ms: the legs take turns in ``rounds`` rounds (the host's speed
    drifts), ``runs`` calls each in all. Returns {name: (p50, q1, q3)}.
    The launches of the legs named in ``uncounted`` are not counted."""
    times = {name: [] for name in legs}
    for r in range(rounds):
        for name, fn in legs.items():
            counts = _counts() if name in uncounted else None
            for i in range(warmup if r == 0 else 0):
                fn()
            torch.cuda.synchronize()
            for _ in range(runs // rounds):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
            if counts is not None:
                for k, n in counts.items():
                    _wrapper(k).launches = n
    out = {}
    for name, ts in times.items():
        q1, p50, q3 = statistics.quantiles(ts, n=4)
        out[name] = (p50, q1, q3)
    return out


def _deploy_k1_plain(fa, gen, b, s, dtype):
    """K1 against its plain version at the served attention (B, S, 12
    heads of 64, non-causal, q/k/v views of one projection) in
    ``dtype``: (max abs error of out, of lse); not counted."""
    h = DEPLOY_BERT["num_attention_heads"]
    d = DEPLOY_BERT["hidden_size"] // h
    err, lse_err, _ = _uncounted(lambda: _kernel_case(
        fa, b, s, s, h, d, False, True, dtype, gen))
    return err, lse_err


def _deploy_child(prefix, inputs, out, t_start):
    """The fresh process of the deploy phase: it imports the port's
    inference module alone, loads the artifact on the card through
    ``Config``/``create_predictor`` (it never builds the model class),
    runs it once on the saved inputs, writes the logits and prints its
    stamps and launches."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    t_imports = time.time()
    pred = inference.create_predictor(inference.Config(prefix))
    torch.cuda.synchronize()
    t_loaded = time.time()
    data = np.load(inputs)
    names = pred.get_input_names()
    pred.get_input_handle(names[0]).copy_from_cpu(data["ids"])
    pred.get_input_handle(names[1]).copy_from_cpu(data["tt"])
    pred.run()
    t_ran = time.time()
    np.save(out, pred.get_output_handle("output_0").copy_to_cpu())
    print(json.dumps({"started_at": t_start, "imports_at": t_imports,
                      "loaded_at": t_loaded, "ran_at": t_ran,
                      "k1_launches": fa.flash_attention_fwd.launches}),
          flush=True)


def _deploy_fresh_process(card, prefix, directory, ids, tt, want):
    """A child process serves the fp32 artifact (relaunched as the
    checkpoint phase relaunches its child); its logits against the
    parent's."""
    repo = os.path.dirname(os.path.abspath(__file__))
    inputs = os.path.join(directory, "inputs.npz")
    out = os.path.join(directory, "child_logits.npy")
    np.savez(inputs, ids=ids, tt=tt)
    t0 = time.time()
    child = subprocess.run([sys.executable, "-c", _DEPLOY_CHILD, repo,
                            prefix, inputs, out], capture_output=True,
                           text=True, timeout=DEPLOY_CHILD_TIMEOUT)
    if child.returncode != 0:
        raise AssertionError(f"the serving child ended with "
                             f"{child.returncode}: {child.stderr[-2000:]}")
    st = json.loads(child.stdout.strip().splitlines()[-1])
    diff = float(np.abs(np.load(out) - want).max())
    row = {"deploy": "fresh process: inference.Config -> create_predictor "
                     "-> run", "card": card,
           "batch": list(ids.shape), "max_abs_diff_to_parent": diff,
           "k1_launches": st["k1_launches"],
           "seconds": {"interpreter_up": st["started_at"] - t0,
                       "imports": st["imports_at"] - st["started_at"],
                       "load": st["loaded_at"] - st["imports_at"],
                       "first_run": st["ran_at"] - st["loaded_at"],
                       "total": st["ran_at"] - t0}}
    log(json.dumps(row))
    if not (diff <= FP32_TOL and st["k1_launches"] ==
            DEPLOY_BERT["num_hidden_layers"]):
        raise AssertionError(f"deploy fresh process: {row}")


def _deploy_serve(paddle, card, prefixes, models, profile):
    """Each artifact through ``Config``/``create_predictor`` at every
    (B, S): K1 once a layer and nothing else; K1 against its plain version
    at that attention shape and dtype (FP32_TOL/BF16_TOL: the served
    model and the eager one launch the same K1, so the logits against
    the eager model check the export, not the kernel); then timed in
    turns (the predictor with its host copies, the ``TranslatedLayer`` on
    device tensors, the eager forward). Returns the fp32 artifact's
    logits by shape."""
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2718)
    layers = DEPLOY_BERT["num_hidden_layers"]
    preds, load_s = {}, {}
    for tag in ("fp32", "bf16"):
        t0 = time.perf_counter()
        preds[tag] = paddle.inference.create_predictor(
            paddle.inference.Config(prefixes[tag]))
        torch.cuda.synchronize()
        load_s[tag] = dict(total=time.perf_counter() - t0,
                           **paddle.jit.load.seconds)
    log(json.dumps({"deploy": "load", "card": card, "seconds": load_s}))
    logits = {}
    for b, s in DEPLOY_SHAPES:
        ids, tt = _deploy_inputs(b, s)
        ids_d, tt_d = (torch.from_numpy(a).cuda() for a in (ids, tt))
        for tag, tol in (("fp32", FP32_TOL), ("bf16", BF16_TOL)):
            pred, model = preds[tag], models[tag]
            k1_err, k1_lse_err = _deploy_k1_plain(
                fa, gen, b, s, torch.float32 if tag == "fp32"
                else torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 1e9
            got, launched = _predict(pred, ids, tt)
            peak = torch.cuda.max_memory_allocated() / 1e9
            _hold_k1(f"{tag} B{b} S{s}", launched, layers)

            def eager():
                return model(paddle.Tensor(ids_d), paddle.Tensor(tt_d))
            want = _uncounted(lambda: eager().numpy())
            err = float(np.abs(got - want).max())
            if tag == "fp32":
                logits[(b, s)] = got
            layer = pred._layer
            legs = _legs_ms({"predictor_run": pred.run,
                             "translated_layer": lambda: layer(ids_d, tt_d),
                             "eager_no_grad": eager},
                            uncounted=("eager_no_grad",))
            row = {"deploy": f"bert_base {tag} B{b} S{s}", "card": card,
                   "k1_max_abs_err_to_plain": k1_err,
                   "k1_lse_max_abs_err_to_plain": k1_lse_err,
                   "max_abs_err_to_eager": err, "tolerance": tol,
                   "launches_a_run": launched,
                   **{f"{name}_p50_ms": t[0] for name, t in legs.items()},
                   **{f"{name}_q1_q3_ms": t[1:] for name, t in legs.items()},
                   "sequences_per_s": b / legs["predictor_run"][0] * 1e3,
                   "resident_gb": resident, "peak_gb": peak}
            if profile and (b, s) == (48, 512):
                prof = _profile(f"deploy {tag} B{b} S{s} Predictor.run",
                                pred.run,
                                groups={"K1": ("flash_fwd",),
                                        "cuBLAS GEMM": ("nvjet", "xmma",
                                                        "cutlass", "cublas"),
                                        "elementwise and reductions": (
                                            "elementwise", "reduce",
                                            "vectorized")})
                row["device_busy_share"] = prof["device_busy_share"]
                row["k1_device_share"] = prof["groups"]["K1"]["share"]
            log(json.dumps(row))
            if not (k1_err <= tol and k1_lse_err <= tol):
                raise AssertionError(
                    f"deploy {tag} B{b} S{s}: K1 disagrees with its plain "
                    f"version: out {k1_err}, lse {k1_lse_err} (tolerance "
                    f"{tol})")
            if not err <= tol:
                raise AssertionError(f"deploy {tag} B{b} S{s}: logits "
                                     f"{err} from the eager model's")
        del ids_d, tt_d
    return logits


def _deploy_twins(paddle, card, prefixes, logits):
    """The fp32 card artifact under ``disable_gpu()`` against the card,
    and the artifact the CPU twin saved, served on the card."""
    layers = DEPLOY_BERT["num_hidden_layers"]
    ids, tt = _deploy_inputs(1, 128)
    cfg = paddle.inference.Config(prefixes["fp32"])
    cfg.disable_gpu()
    host, launched = _predict(paddle.inference.create_predictor(cfg), ids,
                              tt)
    host_err = float(np.abs(host - logits[(1, 128)]).max())
    twin = paddle.inference.create_predictor(
        paddle.inference.Config(prefixes["cpu_twin"]))
    b, s = DEPLOY_CHECK
    ids, tt = _deploy_inputs(b, s)
    got, twin_launched = _predict(twin, ids, tt)
    twin_err = float(np.abs(got - logits[(b, s)]).max())
    row = {"deploy": "twins", "card": card,
           "card_artifact_on_cpu_B1_S128": {"max_abs_diff": host_err,
                                            "launched": launched},
           f"cpu_saved_artifact_on_card_B{b}_S{s}": {
               "max_abs_diff": twin_err, "launched": twin_launched}}
    log(json.dumps(row))
    _hold_k1("the CPU-saved artifact", twin_launched, layers)
    if not (host_err <= LOGITS_TOL and launched == {}
            and twin_err <= FP32_TOL):
        raise AssertionError(f"deploy twins: {row}")


def _deploy_ptq(paddle, card, model, prefix, fp32_prefix, logits, spec):
    """PTQ of BERT-base, saved, reloaded through the predictor and run:
    logits against the quantized eager model, the .pdparams bytes against
    fp32's, argmax agreement with the fp32 artifact on the batch."""
    qmodel = paddle.quantization.PTQ().quantize(model)
    paddle.jit.save(qmodel, prefix, input_spec=spec)
    pred = paddle.inference.create_predictor(paddle.inference.Config(prefix))
    b, s = DEPLOY_CHECK
    ids, tt = _deploy_inputs(b, s)
    got, launched = _predict(pred, ids, tt)
    ids_d, tt_d = (paddle.Tensor(torch.from_numpy(a).cuda())
                   for a in (ids, tt))
    want = _uncounted(lambda: qmodel(ids_d, tt_d).numpy())
    err = float(np.abs(got - want).max())
    q_bytes = os.path.getsize(prefix + ".pdparams")
    fp_bytes = os.path.getsize(fp32_prefix + ".pdparams")
    agree = float((got.argmax(-1) == logits[(b, s)].argmax(-1)).mean())
    row = {"deploy": f"ptq int8 weight-only B{b} S{s}", "card": card,
           "max_abs_err_to_quantized_eager": err,
           "pdparams_bytes": q_bytes, "fp32_pdparams_bytes": fp_bytes,
           "bytes_ratio": q_bytes / fp_bytes,
           "argmax_agreement_with_fp32": agree,
           "max_abs_diff_to_fp32": float(np.abs(
               got - logits[(b, s)]).max()), "launched": launched}
    log(json.dumps(row))
    _hold_k1("ptq", launched, DEPLOY_BERT["num_hidden_layers"])
    if not (err <= FP32_TOL and q_bytes < PTQ_BYTES * fp_bytes):
        raise AssertionError(f"deploy ptq: {row}")
    del qmodel, pred


def _deploy_onnx(paddle, card, directory):
    """onnx.export of ResNet-50 (224x224, B=1, fp32) from card tensors;
    the bundled numpy runtime against the card model."""
    paddle.seed(5)
    model = paddle.vision.models.resnet50()
    model.eval()
    x = np.random.RandomState(7).randn(1, 3, ONNX_HW, ONNX_HW).astype(
        np.float32)
    xt = paddle.to_tensor(x)
    t0 = time.perf_counter()
    path = paddle.onnx.export(model, os.path.join(directory, "resnet50"),
                              input_spec=[xt])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = paddle.onnx.run(path, {"x0": x})[0]
    run_s = time.perf_counter() - t0
    want = model(xt).numpy()
    err = float(np.abs(got - want).max())
    row = {"deploy": f"onnx resnet50 B1 {ONNX_HW}x{ONNX_HW} fp32",
           "card": card, "export_s": export_s,
           "file_bytes": os.path.getsize(path), "numpy_runtime_s": run_s,
           "max_abs_err_to_card": err, "logits_max_abs": float(
               np.abs(want).max())}
    log(json.dumps(row))
    if not err <= LOGITS_TOL:
        raise AssertionError(f"deploy onnx: {row}")
    os.unlink(path)


def phase_deploy(state):
    """BERT-base served from its jit.save artifacts through the inference
    Predictor (fp32, bf16, saved on the CPU, in a fresh process,
    quantized), and ResNet-50 through onnx.export. Runs K1 once a layer
    a Predictor.run; writes under a tempfile.mkdtemp() directory, deleted
    at the end."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.static import InputSpec
    card = _card_line()
    directory = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    t0 = time.perf_counter()
    cfg = BertConfig(**DEPLOY_BERT)
    spec = [InputSpec([-1, -1], "int64"), InputSpec([-1, -1], "int64")]
    prefixes = {tag: os.path.join(directory, tag)
                for tag in ("fp32", "bf16", "cpu_twin", "ptq")}
    try:
        with paddle.device_guard("gpu:0"), paddle.no_grad():
            paddle.seed(21)
            models = {"fp32": BertForSequenceClassification(cfg)}
            host_state = {k: v._data.detach().cpu()
                          for k, v in models["fp32"].state_dict().items()}
            models["bf16"] = BertForSequenceClassification(cfg)
            models["bf16"].set_state_dict(host_state)
            models["bf16"].to(dtype="bfloat16")
            saves = {}
            for tag in ("fp32", "bf16"):
                models[tag].eval()
                t_save = time.perf_counter()
                paddle.jit.save(models[tag], prefixes[tag], input_spec=spec)
                saves[tag] = dict(total=time.perf_counter() - t_save,
                                  **paddle.jit.save.seconds)
            with paddle.device_guard("cpu"):
                twin = BertForSequenceClassification(cfg)
                twin.set_state_dict(host_state)
                t_save = time.perf_counter()
                paddle.jit.save(twin, prefixes["cpu_twin"], input_spec=spec)
                saves["cpu_twin"] = dict(total=time.perf_counter() - t_save,
                                         **paddle.jit.save.seconds)
                del twin
            log(json.dumps({"deploy": "save", "card": card,
                            "seconds": saves, "pdmodel_bytes": {
                                tag: os.path.getsize(prefixes[tag]
                                                     + ".pdmodel")
                                for tag in saves},
                            "pdparams_bytes": {
                                tag: os.path.getsize(prefixes[tag]
                                                     + ".pdparams")
                                for tag in saves}}))
            logits = _deploy_serve(paddle, card, prefixes, models,
                                   state.get("profile"))
            _deploy_twins(paddle, card, prefixes, logits)
            b, s = DEPLOY_CHECK
            ids, tt = _deploy_inputs(b, s)
            _deploy_fresh_process(card, prefixes["fp32"], directory, ids, tt,
                                  logits[(b, s)])
            del models["bf16"]
            _deploy_ptq(paddle, card, models["fp32"], prefixes["ptq"],
                        prefixes["fp32"], logits, spec)
            del models
            torch.cuda.empty_cache()
            _deploy_onnx(paddle, card, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"deploy: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------- static_program
# BERT-base (bench.py _bench_bert's widths, BERT_BASE) served from a
# static.Program: (a) fp32 card against a CPU twin, (b) bf16 at the
# paddle_api rung's shape, (c) its inference model, (d) LeNet from
# static.nn (BASELINE ladder config 1, tests/test_round4b.py:38)
STATIC_CHECK = (2, 128)         # (a): fp32 card vs CPU
STATIC_SHAPE = (BERT_SHAPE["b"], 512)   # (b), (c): B48 S512
STATIC_RUNS = 12                # timed runs of each leg
STATIC_LENET_BATCHES = (256, 100)
#: the pass on BERT-base: two residual norms and one linear+gelu a layer
#: (the embeddings' norm feeds the first projection and the residual,
#: so its norm_linear is rejected)
STATIC_BERT_STATS = {"residual_norm": 24, "linear_act": 12}


def _static_bert(paddle, model, shape):
    """``model`` (a BertModel) built under ``program_guard`` over
    ``data("input_ids", shape, "int64")``: (program, ids, [sequence
    output, pooled output])."""
    main = paddle.static.Program()
    with paddle.static.program_guard(main), paddle.no_grad():
        ids = paddle.static.data("input_ids", list(shape), "int64")
        fetch = list(model(ids))
    return main, ids, fetch


def _static_ids(shape, seed):
    return np.random.RandomState(seed).randint(
        0, BERT_BASE["vocab_size"], shape).astype(np.int64)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _static_run(paddle, exe, main, feed, fetch, fused, **kw):
    paddle.set_flags({"FLAGS_enable_fusion": fused})
    try:
        return exe.run(main, feed=feed, fetch_list=fetch, **kw)
    finally:
        paddle.set_flags({"FLAGS_enable_fusion": False})


def _replayed_ops(main, fused):
    """The steps a run of ``main``'s plan replays (fused: its plan keyed
    with the fusion fingerprint)."""
    return [len(replay.steps) for sig, (replay, _) in main._plans.items()
            if (len(sig) == 4) == fused][-1]


def _static_fp32(paddle, BertModel, cfg):
    """(a) fp32 BERT-base at STATIC_CHECK on the card against the same
    program on a CPU twin, unfused and fused: FP32_TOL; fused against
    unfused on the card: LOGITS_TOL (the fusion phase's fp32 bound); the
    pass's stats equal on both and as predicted."""
    b, s = STATIC_CHECK
    paddle.seed(31)
    card = BertModel(cfg)
    card.eval()
    state = {k: v._data.detach().cpu() for k, v in card.state_dict().items()}
    with paddle.device_guard("cpu"):
        twin = BertModel(cfg)
        twin.set_state_dict(state)
        twin.eval()
        t_main, _, t_fetch = _static_bert(paddle, twin, (b, s))
    c_main, _, c_fetch = _static_bert(paddle, card, (b, s))
    feed = {"input_ids": _static_ids((b, s), 5)}
    out = {}
    for fused in (False, True):
        with paddle.device_guard("cpu"):
            ref = _static_run(paddle, paddle.static.Executor(), t_main, feed,
                              t_fetch, fused)
        got = _static_run(paddle, paddle.static.Executor(), c_main, feed,
                          c_fetch, fused)
        err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
        out[fused] = (got, err)
        log(f"static_program (a) fp32 B{b} S{s} {'fused' if fused else 'unfused'}"
            f": card vs CPU max abs err {err:.3e} (tolerance {FP32_TOL})")
        if not (err <= FP32_TOL and all(np.isfinite(g).all() for g in got)):
            raise AssertionError(f"static_program (a): the card's "
                                 f"{'fused ' if fused else ''}run is "
                                 f"{err} from the CPU twin's")
    gap = max(float(np.abs(f - u).max())
              for f, u in zip(out[True][0], out[False][0]))
    stats = (c_main.fusion_stats["rewritten"],
             t_main.fusion_stats["rewritten"])
    log(f"static_program (a): fused vs unfused on the card {gap:.3e} "
        f"(tolerance {LOGITS_TOL}); rewritten {stats[0]} (CPU {stats[1]})")
    if not (gap <= LOGITS_TOL and stats[0] == stats[1] == STATIC_BERT_STATS
            and c_main.fusion_stats["rejected"] == {"norm_linear": 1}):
        raise AssertionError(f"static_program (a): fused {gap} from "
                             f"unfused, stats {c_main.fusion_stats}")


def _static_bf16(paddle, BertModel, cfg, card):
    """(b) bf16 BERT-base at STATIC_SHAPE: Executor.run unfused and fused
    against the eager forward (norm-wise BF16_TOL), the launches a run,
    then the three timed in turns. Returns (program, ids Tensor,
    fetches, the unfused run's outputs, the feed)."""
    b, s = STATIC_SHAPE
    layers = cfg.num_hidden_layers
    paddle.seed(32)
    model = BertModel(cfg)
    model.to(dtype="bfloat16")
    model.eval()
    t0 = time.perf_counter()
    main, ids, fetch = _static_bert(paddle, model, (b, s))
    build_s = time.perf_counter() - t0
    feed = {"input_ids": _static_ids((b, s), 6)}
    ids_d = torch.from_numpy(feed["input_ids"]).cuda()
    with paddle.no_grad():
        eager = _uncounted(lambda: [o.numpy() for o in model(
            paddle.Tensor(ids_d))])
    exe = paddle.static.Executor()
    runs, launched = {}, {}
    for fused in (False, True):
        before = _counts()
        runs[fused] = _static_run(paddle, exe, main, feed, fetch, fused)
        launched[fused] = _launched(before, _counts())
    stats = main.fusion_stats["rewritten"]
    want = {False: {"flash_attention_fwd": layers},
            True: {"flash_attention_fwd": layers,
                   "fused_residual_norm": stats.get("residual_norm", 0),
                   "fused_matmul": stats.get("linear_act", 0)}}
    errs = {fused: [_norm_err(g, e) for g, e in zip(runs[fused], eager)]
            for fused in (False, True)}
    feed_d = {"input_ids": ids_d}

    def leg(fused):
        return lambda: _static_run(paddle, exe, main, feed_d, fetch, fused,
                                   return_numpy=False)
    host = {}
    for fused in (False, True):
        torch.cuda.synchronize()
        ts = []
        for _ in range(STATIC_RUNS):
            counts = _counts()
            t1 = time.perf_counter()
            leg(fused)()
            ts.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            for k, n in counts.items():
                _wrapper(k).launches = n
        host[fused] = statistics.median(ts)

    def eager_leg():
        with paddle.no_grad():
            model(paddle.Tensor(ids_d))
    legs = _legs_ms({"executor_unfused": leg(False),
                     "executor_fused": leg(True), "eager_no_grad": eager_leg},
                    uncounted=("executor_unfused", "executor_fused",
                               "eager_no_grad"),
                    runs=STATIC_RUNS * 2, rounds=2)
    row = {"static_program": f"bert_base bf16 B{b} S{s} Executor.run",
           "card": card, "build_s": build_s,
           "max_norm_err_to_eager": {"unfused": max(errs[False]),
                                     "fused": max(errs[True])},
           "tolerance": BF16_TOL,
           "launches_a_run": {"unfused": launched[False],
                              "fused": launched[True]},
           "fusion_stats": main.fusion_stats,
           "ops_replayed_a_run": {"unfused": _replayed_ops(main, False),
                                  "fused": _replayed_ops(main, True)},
           "ops_recorded": len(main.global_block().ops),
           "host_ms_a_run": {"unfused": host[False], "fused": host[True]},
           **{f"{name}_p50_ms": t[0] for name, t in legs.items()},
           **{f"{name}_q1_q3_ms": t[1:] for name, t in legs.items()},
           "sequences_per_s": {name: b / t[0] * 1e3
                               for name, t in legs.items()}}
    log(json.dumps(row))
    for fused in (False, True):
        if launched[fused] != want[fused]:
            raise AssertionError(f"static_program (b): a {'fused' if fused else 'unfused'} "
                                 f"run launched {launched[fused]}, want "
                                 f"{want[fused]}")
        if not max(errs[fused]) <= BF16_TOL:
            raise AssertionError(f"static_program (b): Executor.run is "
                                 f"{errs[fused]} from the eager forward")
    if stats != STATIC_BERT_STATS:
        raise AssertionError(f"static_program (b): fusion_stats {stats}")
    return main, ids, fetch, runs[False], feed


def _static_deploy(paddle, main, ids, fetch, want, feed, directory, card):
    """(c) (b)'s unfused program through save_inference_model,
    load_inference_model and create_predictor: both outputs norm-wise
    within BF16_TOL of (b)'s unfused run, K1 12 a run and nothing else,
    the seconds of each step and the ms a run."""
    layers = BERT_BASE["num_hidden_layers"]
    prefix = os.path.join(directory, "static_bert")
    t0 = time.perf_counter()
    paddle.static.save_inference_model(prefix, [ids], fetch, program=main)
    save_s = dict(total=time.perf_counter() - t0, **paddle.jit.save.seconds)
    t0 = time.perf_counter()
    layer, feeds, fetches = paddle.static.load_inference_model(prefix)
    load_s = dict(total=time.perf_counter() - t0, **paddle.jit.load.seconds)
    t0 = time.perf_counter()
    pred = paddle.inference.create_predictor(paddle.inference.Config(prefix))
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    ids_d = torch.from_numpy(feed["input_ids"]).cuda()
    before = _counts()
    got_layer = [o.numpy() for o in layer(ids_d)]
    k_layer = _launched(before, _counts())
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(
        feed["input_ids"])
    before = _counts()
    pred.run()
    k_pred = _launched(before, _counts())
    got_pred = [pred.get_output_handle(n).copy_to_cpu()
                for n in pred.get_output_names()]
    errs = {"translated_layer": [_norm_err(g, w) for g, w in
                                 zip(got_layer, want)],
            "predictor": [_norm_err(g, w) for g, w in zip(got_pred, want)]}
    legs = _legs_ms({"predictor_run": pred.run,
                     "translated_layer": lambda: layer(ids_d)},
                    uncounted=("predictor_run", "translated_layer"),
                    runs=STATIC_RUNS, rounds=2)
    row = {"static_program": f"bert_base bf16 B{STATIC_SHAPE[0]} "
                             f"S{STATIC_SHAPE[1]} inference model",
           "card": card, "save_inference_model_s": save_s,
           "load_inference_model_s": load_s, "create_predictor_s": pred_s,
           "feeds": feeds, "fetches": fetches,
           "pdmodel_bytes": os.path.getsize(prefix + ".pdmodel"),
           "pdparams_bytes": os.path.getsize(prefix + ".pdparams"),
           "max_norm_err_to_executor": {k: max(v) for k, v in errs.items()},
           "tolerance": BF16_TOL,
           "launches_a_run": {"translated_layer": k_layer,
                              "predictor": k_pred},
           **{f"{name}_p50_ms": t[0] for name, t in legs.items()},
           **{f"{name}_q1_q3_ms": t[1:] for name, t in legs.items()}}
    log(json.dumps(row))
    for label, k in (("TranslatedLayer", k_layer), ("Predictor.run", k_pred)):
        if k != {"flash_attention_fwd": layers}:
            raise AssertionError(f"static_program (c): {label} launched "
                                 f"{k}, want flash_attention_fwd {layers}")
    for label, e in errs.items():
        if not (len(e) == 2 and max(e) <= BF16_TOL):
            raise AssertionError(f"static_program (c): {label} is {e} from "
                                 f"the program's run")


def _static_lenet(paddle, pkg_dev):
    """LeNet from static.nn primitives over [None, 1, 28, 28] (BASELINE
    ladder config 1) built on ``pkg_dev``: (program, img, logits)."""
    F = paddle.nn.functional
    main = paddle.static.Program()
    with paddle.device_guard(pkg_dev), paddle.static.program_guard(main):
        img = paddle.static.data("img", [None, 1, 28, 28], "float32")
        c1 = paddle.static.nn.conv2d(img, 6, 5, padding=2, act="relu")
        c2 = paddle.static.nn.conv2d(F.max_pool2d(c1, 2, 2), 16, 5,
                                     act="relu")
        flat = F.max_pool2d(c2, 2, 2).flatten(start_axis=1)
        f1 = paddle.static.nn.fc(flat, 120, activation="relu")
        f2 = paddle.static.nn.fc(f1, 84, activation="relu")
        logits = paddle.static.nn.fc(f2, 10)
    return main, img, logits


def _persistables(main):
    return [t for t in main._captured.values()
            if getattr(t, "persistable", False)]


def _static_nn(paddle):
    """(d) LeNet from static.nn at batches STATIC_LENET_BATCHES from one
    program on the card against its CPU twin (FP32_TOL); a py_func in a
    card program against numpy; an EMA's apply and restore on the card's
    LeNet weights, the program reading the applied ones live."""
    paddle.seed(33)
    card, _, c_out = _static_lenet(paddle, "gpu:0")
    twin, _, t_out = _static_lenet(paddle, "cpu")
    for a, b in zip(_persistables(card), _persistables(twin)):
        b.set_value(a._data.cpu())
    errs = []
    for k, b in enumerate(STATIC_LENET_BATCHES):
        feed = {"img": np.random.RandomState(40 + k).randn(
            b, 1, 28, 28).astype(np.float32)}
        (got,) = paddle.static.Executor(paddle.CUDAPlace(0)).run(
            card, feed, [c_out])
        (ref,) = paddle.static.Executor(paddle.CPUPlace()).run(
            twin, feed, [t_out])
        errs.append(float(np.abs(got - ref).max()))
        if got.shape != (b, 10) or not errs[-1] <= FP32_TOL:
            raise AssertionError(f"static_program (d): LeNet at B{b} is "
                                 f"{errs[-1]} from its CPU twin")
    # py_func: the host callback runs at every run, inside the replay
    calls = []

    def host(a):
        calls.append(a.shape)
        return np.sort(a, axis=-1)
    main = paddle.static.Program()
    with paddle.device_guard("gpu:0"), paddle.static.program_guard(main):
        x = paddle.static.data("x", [64, 32], "float32")
        tmpl = paddle.to_tensor(np.zeros((64, 32), np.float32))
        y = paddle.static.nn.py_func(host, x * 2.0, tmpl) + 1.0
    xv = np.random.RandomState(45).randn(64, 32).astype(np.float32)
    calls.clear()
    for _ in range(2):
        (py,) = paddle.static.Executor(paddle.CUDAPlace(0)).run(
            main, {"x": xv}, [y])
    py_err = float(np.abs(py - (np.sort(xv * 2.0, -1) + 1.0)).max())
    if not (py_err <= FP32_TOL and len(calls) == 2):
        raise AssertionError(f"static_program (d): py_func {py_err}, "
                             f"called {len(calls)} times in 2 runs")
    # EMA over the card LeNet's trainable weights
    params = [p for p in _persistables(card) if not p.stop_gradient]
    ema = paddle.static.ExponentialMovingAverage(decay=0.9,
                                                 parameters=params)
    start = [p._data.detach().clone() for p in params]
    ema.update()
    with torch.no_grad():
        for p in params:
            p._data.add_(1.0)
    ema.update()
    feed = {"img": np.random.RandomState(46).randn(
        8, 1, 28, 28).astype(np.float32)}
    exe = paddle.static.Executor(paddle.CUDAPlace(0))
    (live,) = exe.run(card, feed, [c_out])
    with ema.apply():
        shadow_err = max(float((p._data.detach() - (s + 0.1)).abs().max())
                         for p, s in zip(params, start))
        (applied,) = exe.run(card, feed, [c_out])
    restored = max(float((p._data.detach() - (s + 1.0)).abs().max())
                   for p, s in zip(params, start))
    (again,) = exe.run(card, feed, [c_out])
    log(f"static_program (d): LeNet card vs CPU max abs err {errs} at "
        f"B{STATIC_LENET_BATCHES} (tolerance {FP32_TOL}); py_func "
        f"{py_err:.3e} over {len(calls)} runs; EMA shadow err "
        f"{shadow_err:.3e}, restored err {restored:.3e}")
    if not (shadow_err <= FP32_TOL and restored == 0.0
            and float(np.abs(again - live).max()) <= FP32_TOL
            and not np.allclose(applied, live)):
        raise AssertionError("static_program (d): the EMA's apply and "
                             "restore")


def phase_static_program(state):
    """BERT-base served from a static.Program: (a) fp32 card vs CPU twin,
    (b) bf16 B48 S512 through K1, K4 and K6 from Executor.run, (c) its
    inference model through load_inference_model and the Predictor,
    (d) LeNet, py_func and an EMA from static.nn. Writes under a
    tempfile.mkdtemp() directory, deleted at the end."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import BertConfig, BertModel
    card = _card_line()
    cfg = BertConfig(**BERT_BASE)
    directory = tempfile.mkdtemp(prefix="chip_smoke_static_")
    t0 = time.perf_counter()
    try:
        with paddle.device_guard("gpu:0"):
            _static_fp32(paddle, BertModel, cfg)
            torch.cuda.empty_cache()
            main, ids, fetch, want, feed = _static_bf16(paddle, BertModel,
                                                        cfg, card)
            _static_deploy(paddle, main, ids, fetch, want, feed, directory,
                           card)
            del main, ids, fetch
            torch.cuda.empty_cache()
            _static_nn(paddle)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"static_program: phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- seq2seq
# Transformer-base (Vaswani et al. 2017, Table 3 "base", sections 3.4-3.5
# and 5.1-5.4) on the port's nn.Transformer at its published settings
SEQ2SEQ = dict(d_model=512, nhead=8, num_encoder_layers=6,
               num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
SEQ2SEQ_VOCAB = 37000           # the shared source/target vocabulary, 5.1
SEQ2SEQ_BATCH = dict(b=32, s=128)   # 4096 source + 4096 target tokens
SEQ2SEQ_PARITY = dict(b=4, s=32)    # the fp32 card-vs-CPU steps
# the first parity step's gradients, card vs CPU, each parameter
# norm-wise; the floor covers the attention key biases, whose gradient is
# zero up to rounding (softmax ignores a constant added to a row's scores)
SEQ2SEQ_GRAD_TOL = 1e-3
SEQ2SEQ_GRAD_FLOOR = 1e-3
SEQ2SEQ_SMOOTHING = 0.1         # label smoothing, 5.4
SEQ2SEQ_ADAM = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)   # 5.3
SEQ2SEQ_WARMUP = 4000           # NoamDecay's warmup steps, 5.3
SEQ2SEQ_STEPS, SEQ2SEQ_WARM_STEPS = 10, 2
SEQ2SEQ_NEW = 128               # greedy tokens a source
SEQ2SEQ_CPU_STEPS, SEQ2SEQ_CPU_ROWS = 8, 4      # decode logits on the CPU


def _sinusoid(n, d):
    """The sinusoidal positions of section 3.5, (n, d) fp32."""
    pos = np.arange(n)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


def _seq2seq_model(paddle, dropout, seed=17):
    """nn.Transformer with one embedding shared by the source, the target
    and the pre-softmax projection, scaled by sqrt(d_model) (3.4), plus
    sinusoidal positions (3.5), on the current device."""
    d = SEQ2SEQ["d_model"]

    class Seq2Seq(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = paddle.nn.Embedding(
                SEQ2SEQ_VOCAB, d, weight_attr=paddle.nn.initializer.Normal(
                    0.0, d ** -0.5))
            self.transformer = paddle.nn.Transformer(
                **dict(SEQ2SEQ, dropout=dropout))
            self.drop = paddle.nn.Dropout(dropout)
            self.register_buffer("pos", paddle.to_tensor(_sinusoid(max(
                SEQ2SEQ_NEW, SEQ2SEQ_BATCH["s"], SEQ2SEQ_PARITY["s"]), d)))

        def tokens(self, ids, start=0):
            x = self.embed(ids) * (d ** 0.5)
            return self.drop(x + self.pos[start:start + ids.shape[1]])

        def logits(self, h):
            return paddle.matmul(h, self.embed.weight, transpose_y=True)

        def forward(self, src, tgt_in):
            memory = self.transformer.encoder(self.tokens(src))
            mask = paddle.nn.Transformer.generate_square_subsequent_mask(
                tgt_in.shape[1])
            return self.logits(self.transformer.decoder(
                self.tokens(tgt_in), memory, mask))

    paddle.seed(seed)
    return Seq2Seq()


def _seq2seq_loss(paddle, model, src, tgt):
    """Label-smoothed (epsilon 0.1) soft-label cross entropy of the next
    target token, the target shifted right behind token 0."""
    F = paddle.nn.functional
    tgt_in = paddle.concat([paddle.zeros([tgt.shape[0], 1], "int64"),
                            tgt[:, :-1]], axis=1)
    logits = model(src, tgt_in)
    soft = F.label_smooth(F.one_hot(tgt, SEQ2SEQ_VOCAB),
                          epsilon=SEQ2SEQ_SMOOTHING)
    return F.cross_entropy(logits, soft, soft_label=True)


def _seq2seq_opt(paddle, model):
    sched = paddle.optimizer.lr.NoamDecay(d_model=SEQ2SEQ["d_model"],
                                          warmup_steps=SEQ2SEQ_WARMUP)
    return sched, paddle.optimizer.Adam(
        learning_rate=sched, parameters=model.parameters(), **SEQ2SEQ_ADAM)


def _seq2seq_batch(paddle, seed, b, s):
    rng = np.random.RandomState(seed)
    return tuple(paddle.to_tensor(rng.randint(
        1, SEQ2SEQ_VOCAB, (b, s)).astype(np.int64)) for _ in range(2))


def _seq2seq_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _seq2seq_parity(paddle):
    """3 fp32 steps, dropout 0, on the card and on a CPU twin carrying
    the same state: the losses within LOSS_TOL, and the first step's
    gradients (through K2/K3 on the card) each norm-wise within
    SEQ2SEQ_GRAD_TOL of the larger of its norm and SEQ2SEQ_GRAD_FLOOR of
    the largest."""
    card = _seq2seq_model(paddle, dropout=0.0)
    with paddle.device_guard("cpu"):
        twin = _seq2seq_model(paddle, dropout=0.0, seed=18)
        twin.set_state_dict(_seq2seq_state(card))
    losses, grads = [], []
    for model, dev in ((card, "gpu:0"), (twin, "cpu")):
        with paddle.device_guard(dev):
            sched, opt = _seq2seq_opt(paddle, model)
            run = []
            for step in range(3):
                src, tgt = _seq2seq_batch(paddle, 100 + step,
                                          **SEQ2SEQ_PARITY)
                loss = _seq2seq_loss(paddle, model, src, tgt)
                loss.backward()
                if step == 0:
                    grads.append([p.grad.numpy().astype(np.float64)
                                  for p in model.parameters()])
                opt.step()
                opt.clear_grad()
                sched.step()
                run.append(float(loss.item()))
            losses.append(run)
    diff = max(abs(a - b) for a, b in zip(*losses))
    largest = max(np.linalg.norm(g) for g in grads[1])
    errs = sorted(
        (float(np.linalg.norm(a - b)
               / max(np.linalg.norm(b), SEQ2SEQ_GRAD_FLOOR * largest)), name)
        for (name, _), a, b in zip(twin.named_parameters(), *grads))
    log(f"seq2seq: fp32 B{SEQ2SEQ_PARITY['b']} S{SEQ2SEQ_PARITY['s']} "
        f"card losses {losses[0]} CPU {losses[1]} max diff {diff:.3e} "
        f"(tolerance {LOSS_TOL}); first step's gradients norm-wise "
        f"{errs[-1][0]:.3e} (limit {SEQ2SEQ_GRAD_TOL}), worst "
        f"{errs[-3:][::-1]}")
    if not (np.isfinite(losses[0]).all() and diff <= LOSS_TOL
            and errs[-1][0] <= SEQ2SEQ_GRAD_TOL):
        raise AssertionError(f"seq2seq parity: card {losses[0]} vs CPU "
                             f"{losses[1]}, gradients {errs[-1]}")
    del card, twin


SEQ2SEQ_GROUPS = {"K1 attention": ("flash_fwd",),
                  "cuBLAS GEMM": ("nvjet", "xmma", "cutlass", "cublas",
                                  "gemm"),
                  "softmax and cross entropy": ("softmax",),
                  "elementwise and reductions": ("elementwise", "reduce",
                                                 "vectorized")}


def _seq2seq_train(paddle, model, card, profile=False):
    """bf16 amp O1 steps at dropout 0.1: SEQ2SEQ_WARM_STEPS, then
    SEQ2SEQ_STEPS timed, split by CUDA events; one JSON line (with
    ``profile``, a torch.profiler breakdown of one more step)."""
    from paddle_tpu_torch import amp
    b, s = SEQ2SEQ_BATCH["b"], SEQ2SEQ_BATCH["s"]
    sched, opt = _seq2seq_opt(paddle, model)
    batches = [_seq2seq_batch(paddle, i, b, s)
               for i in range(SEQ2SEQ_WARM_STEPS + SEQ2SEQ_STEPS)]
    walls, split, losses = [], [], []
    for i, (src, tgt) in enumerate(batches):
        if i == SEQ2SEQ_WARM_STEPS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        with amp.auto_cast(**O1):
            loss = _seq2seq_loss(paddle, model, src, tgt)
        events[1].record()
        loss.backward()
        events[2].record()
        opt.step()
        opt.clear_grad()
        sched.step()
        events[3].record()
        torch.cuda.synchronize()
        if i >= SEQ2SEQ_WARM_STEPS:
            walls.append(time.perf_counter() - t0)
            split.append([events[j].elapsed_time(events[j + 1])
                          for j in range(3)])
        losses.append(float(loss.item()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        src, tgt = batches[-1]

        def step():
            with amp.auto_cast(**O1):
                loss = _seq2seq_loss(paddle, model, src, tgt)
            loss.backward()
            opt.step()
            opt.clear_grad()
        _profile("seq2seq O1 train step", step, groups=SEQ2SEQ_GROUPS)
    q1, median, q3 = statistics.quantiles(walls, n=4)
    fwd, bwd, upd = (statistics.median(x[j] for x in split)
                     for j in range(3))
    d, ff = SEQ2SEQ["d_model"], SEQ2SEQ["dim_feedforward"]
    enc = sum(p.size for p in model.transformer.encoder.parameters())
    dec = sum(p.size for p in model.transformer.decoder.parameters())
    tokens = b * s
    # 6 FLOPs a parameter a token (forward and backward) for each stack on
    # its own tokens and for the pre-softmax projection on the targets, and
    # 12 d S a token a layer for each attention (scores and values, forward
    # and backward; the decoder's causal self-attention counted whole)
    flops = 6 * (enc * tokens + dec * tokens + d * SEQ2SEQ_VOCAB * tokens) \
        + 12 * d * s * tokens * (SEQ2SEQ["num_encoder_layers"]
                                 + 2 * SEQ2SEQ["num_decoder_layers"])
    row = {"seq2seq": f"transformer_base O1 bf16 B{b} S{s}+{s} train",
           "card": card, "params": sum(p.size for p in model.parameters()),
           "steps": len(walls), "step_ms": median * 1e3,
           "step_ms_q1": q1 * 1e3, "step_ms_q3": q3 * 1e3,
           "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": upd,
           "target_tokens_per_s": tokens / median, "flops_a_step": flops,
           "mfu": flops / median / BF16_FLOP_PER_S, "peak_memory_gb": peak,
           "losses": losses, "dropout": SEQ2SEQ["dropout"], "d_ff": ff,
           "lr_last": sched.get_lr()}
    log(json.dumps(row))
    if not np.isfinite(losses).all():
        raise AssertionError(f"seq2seq training losses {losses}")
    del opt, batches


def _seq2seq_greedy(paddle, model, src, n_new, keep_logits=0):
    """Greedy ids from token 0 through ``decoder.gen_cache`` and one
    cached decoder call a token; the first ``keep_logits`` steps' logits
    and every step's top-two gap come back too."""
    memory = model.transformer.encoder(model.tokens(src))
    cache = model.transformer.decoder.gen_cache(memory)
    tok = paddle.zeros([src.shape[0], 1], "int64")
    ids, kept = [], []
    for t in range(n_new):
        h, cache = model.transformer.decoder(model.tokens(tok, t), memory,
                                             cache=cache)
        logits = model.logits(h)[:, -1]
        if t < keep_logits:
            kept.append(logits.numpy())
        tok = paddle.argmax(logits, axis=-1, keepdim=True)
        ids.append(tok)
    return paddle.concat(ids, axis=1).numpy(), kept


def _seq2seq_recompute(paddle, model, src, n_new):
    """The reference: the whole prefix through the decoder each step under
    the causal mask; (ids, each step's top-two gap)."""
    memory = model.transformer.encoder(model.tokens(src))
    prefix = paddle.zeros([src.shape[0], 1], "int64")
    ids, gaps = [], []
    for _ in range(n_new):
        mask = paddle.nn.Transformer.generate_square_subsequent_mask(
            prefix.shape[1])
        h = model.transformer.decoder(model.tokens(prefix), memory, mask)
        logits = model.logits(h)[:, -1]
        top = paddle.topk(logits, 2, axis=-1)[0].numpy()
        gaps.append(top[:, 0] - top[:, 1])
        tok = paddle.argmax(logits, axis=-1, keepdim=True)
        ids.append(tok)
        prefix = paddle.concat([prefix, tok], axis=1)
    return paddle.concat(ids, axis=1).numpy(), np.stack(gaps, axis=1)


def _seq2seq_decode(paddle, model, card, profile=False):
    """fp32 greedy decode of the 32 sources held against the full
    recompute and (the first steps' logits) a CPU twin; K1's launches;
    then the bf16 decode, timed (with ``profile``, a torch.profiler
    breakdown of 16 more tokens)."""
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    b, s = SEQ2SEQ_BATCH["b"], SEQ2SEQ_BATCH["s"]
    src, _ = _seq2seq_batch(paddle, 999, b, s)
    layers = SEQ2SEQ["num_decoder_layers"]
    model.eval()
    with paddle.no_grad():
        before = fa.flash_attention_fwd.launches
        ids, kept = _seq2seq_greedy(paddle, model, src, SEQ2SEQ_NEW,
                                    SEQ2SEQ_CPU_STEPS)
        launched = fa.flash_attention_fwd.launches - before
        want = SEQ2SEQ["num_encoder_layers"] + 2 * layers * SEQ2SEQ_NEW
        log(f"seq2seq: fp32 greedy decode of {b} sources, {SEQ2SEQ_NEW} "
            f"tokens: K1 launched {launched} (want {want})")
        if launched != want:
            raise AssertionError(f"seq2seq decode launched K1 {launched} "
                                 f"times, wants {want}")
        ref, gaps = _seq2seq_recompute(paddle, model, src, SEQ2SEQ_NEW)
        _hold("seq2seq cached decode vs full recompute",
              [list(r) for r in ids], [list(r) for r in ref],
              lambda i, j: float(gaps[i, j]))
        with paddle.device_guard("cpu"):
            twin = _seq2seq_model(paddle, dropout=0.0, seed=18)
            twin.set_state_dict(_seq2seq_state(model))
            twin.eval()
            rows = SEQ2SEQ_CPU_ROWS
            src_cpu = paddle.to_tensor(src.numpy()[:rows])
            memory = twin.transformer.encoder(twin.tokens(src_cpu))
            cache = twin.transformer.decoder.gen_cache(memory)
            tok = np.zeros((rows, 1), np.int64)
            worst = 0.0
            for t in range(SEQ2SEQ_CPU_STEPS):
                h, cache = twin.transformer.decoder(
                    twin.tokens(paddle.to_tensor(tok), t), memory,
                    cache=cache)
                got = twin.logits(h)[:, -1].numpy()
                worst = max(worst, float(np.abs(kept[t][:rows] - got).max()))
                tok = ids[:rows, t:t + 1]       # the card's tokens
        log(f"seq2seq: the first {SEQ2SEQ_CPU_STEPS} steps' logits of "
            f"{rows} sources, card vs CPU max_abs_diff={worst:.3e} "
            f"(tolerance {LOGITS_TOL})")
        if not (np.isfinite(kept[0]).all() and worst <= LOGITS_TOL):
            raise AssertionError(f"seq2seq decode logits disagree: {worst}")
        del twin
        model.to(dtype="bfloat16")
        _seq2seq_greedy(paddle, model, src, 4)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids16, _ = _seq2seq_greedy(paddle, model, src, SEQ2SEQ_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if profile:
            _profile("seq2seq bf16 decode, 16 tokens",
                     lambda: _seq2seq_greedy(paddle, model, src, 16),
                     groups=SEQ2SEQ_GROUPS)
    agree = float((ids16 == ids).mean())
    log(json.dumps({"seq2seq": f"transformer_base bf16 greedy decode B{b} "
                                f"S{s} +{SEQ2SEQ_NEW}", "card": card,
                    "ms_a_token": wall / SEQ2SEQ_NEW * 1e3,
                    "tokens_per_s": b * SEQ2SEQ_NEW / wall,
                    "k1_launches_fp32_decode": launched,
                    "ids_agree_with_fp32": agree}))


def phase_seq2seq(state):
    """Transformer-base at full width on one card: fp32 parity steps
    against a CPU twin, bf16 training steps, the greedy decode through the
    caches (K1 at every attention) held against the full recompute and
    the CPU, and its bf16 time."""
    import paddle_tpu_torch as paddle
    card = _card_line()
    with paddle.device_guard("gpu:0"):
        _seq2seq_parity(paddle)
        model = _seq2seq_model(paddle, dropout=SEQ2SEQ["dropout"])
        model.train()
        _seq2seq_train(paddle, model, card, state.get("profile"))
        _seq2seq_decode(paddle, model, card, state.get("profile"))
        del model
    torch.cuda.empty_cache()


# -------------------------------------------------------------------- ops
# every recipe of tests/test_op_sweep.py (its R, built by running that
# file's input makers and recipe block, which are numpy only), on the card
# against the same op on CPU tensors
OPS_BIG = (4096, 4096)          # elementwise, reductions and the like
OPS_BIG_BF16 = (2048, 2048)     # their bf16 checks (the CPU's bf16 is slow)
OPS_LINALG = 512                # linalg: 512 x 512, square ones batched
OPS_BATCH = 16
OPS_FFT = 2 ** 20
OPS_STFT = dict(b=32, n=16000, n_fft=512, hop=160)   # 1 s at 16 kHz
OPS_GRAPH = dict(nodes=100_000, edges=1_000_000, feat=64)
# card vs CPU, the largest |difference| over the largest |CPU value| (or
# 1): fp32, and bf16 (each side rounds in its own order)
OPS_TOL = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
# categories whose recipes grow to OPS_BIG when every array input has one
# 2-D shape (the recipes whose inputs are not one 2-D shape are built by
# OPS_GROWN below)
OPS_BIG_CATEGORIES = ("math", "activation", "reduction", "manipulation",
                      "search", "creation", "nn_common", "loss", "indexing",
                      "norm")
# the recipes that run at their own size, each for its reason
OPS_AT_RECIPE = {
    "atleast_1d": "its case is a 0-d input",
    "increment": "a one-element tensor by definition",
    "frame": "run at OPS_STFT by _ops_extra as well",
    "overlap_add": "run at OPS_STFT by _ops_extra as well"}
# random draws: shapes and dtypes only (the card's and the CPU's
# generators are different streams)
OPS_RANDOM = ("gumbel_softmax", "normal_", "bernoulli_", "log_normal_",
              "cauchy_", "geometric_", "standard_gamma", "poisson",
              "bernoulli", "binomial")
# eigenvalues come in no fixed order: compared sorted, the vectors not
OPS_UNORDERED = ("eig", "eigvals")
# integral outputs of a rounding of floats: a value on a rounding edge
# may go either way on the two devices (at most 1e-4 of them may differ)
OPS_NEAR_INT = ("weight_quantize", "histogram")
# outputs fixed up to a sign (a phase) per column: compared in magnitude
OPS_SIGNED = ("pca_lowrank",)
# decompositions: the factors' products compared (a basis of an
# eigenspace, and each vector's sign, is the device's choice)
OPS_PRODUCTS = {
    "svd": lambda u, s, vh: (u * s[..., None, :]) @ vh,
    "qr": lambda q, r: q @ r,
    "eigh": lambda w, v: (v * w[..., None, :]) @ v.transpose(-1, -2)}
# the fusion ops at a transformer block's widths (their recipes' are
# below what the fused kernels take)
OPS_FUSED = {
    "fused_bias_act": lambda rng: [_rand(rng, 4096, 4096),
                                   _rand(rng, 4096)],
    "fused_residual_norm": lambda rng: [
        _rand(rng, 4096, 1024), _rand(rng, 4096, 1024),
        _rand(rng, 1024) + 1.0, _rand(rng, 1024)],
    "fused_norm_linear": lambda rng: [_rand(rng, 4096, 1024),
                                      _rand(rng, 1024, 4096) * 0.03],
    "fused_rope_proj": lambda rng: [_rand(rng, 8, 512, 1024),
                                    _rand(rng, 1024, 1024) * 0.03]}
OPS_FUSED_ATTRS = {"fused_rope_proj": {"num_heads": 16}}


def _sweep_recipes():
    """(R, BF16_SKIP) of tests/test_op_sweep.py: its recipe block and its
    bf16 skip table run here, with the same seeded input makers."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_op_sweep.py")
    with open(path) as f:
        src = f.read()
    # its seeded input makers (numpy only), from RNG = ... up to R = {}
    scope = dict(np=np)
    makers = src[src.index("\nRNG = np.random.RandomState("):src.index(
        "\nR = {}")]
    exec(compile(makers, path, "exec"), scope)
    block = src[src.index("\nR = {}"):src.index(
        "\n# ---------------------------------------------------------------- "
        "skips")]
    exec(compile(block, path, "exec"), scope)
    skip = src[src.index("\nBF16_SKIP = {"):src.index("\ndef _bf16_eligible")]
    exec(compile(skip, path, "exec"), scope)
    return scope["R"], scope["BF16_SKIP"]


_JITTER = {}


def _grow(a, shape, rng):
    """A recipe array grown to ``shape``: its values repeated (np.tile:
    np.resize takes ten times as long), floats scaled by a factor in
    [0.99, 1.01] (the recipe's domain, few ties; one draw of factors a
    shape, shared)."""
    n, flat = int(np.prod(shape)), a.ravel()
    big = np.tile(flat, -(-n // flat.size))[:n].reshape(shape)
    if big.dtype == np.float32:
        if shape not in _JITTER:
            _JITTER[shape] = rng.uniform(0.99, 1.01, shape).astype(
                np.float32)
        big *= _JITTER[shape]
    return big


def _rand(rng, *shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def _spd(n, b, rng):
    """b symmetric positive definite n x n matrices (one, unbatched, for
    b 0), eigenvalues in about [1, 5]."""
    a = rng.randn(max(b, 1), n, n).astype(np.float32) / np.sqrt(n)
    out = a @ a.transpose(0, 2, 1) + np.eye(n, dtype=np.float32)
    return out if b else out[0]


def _linalg_dim(d):
    """A recipe dim at linalg size: 3 -> OPS_LINALG / 2, the larger ones
    -> OPS_LINALG (the recipe's tall shapes stay tall), 1 and 2 kept."""
    return d if d <= 2 else OPS_LINALG // 2 if d == 3 else OPS_LINALG


def _ints(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype(np.int64)


def _img(rng, n, c=64, hw=56):
    """An NCHW batch of n // 128 images (32 at OPS_BIG)."""
    return _rand(rng, n // 128, c, hw, hw)


def _chol(rng):
    """OPS_BATCH lower Cholesky factors of OPS_LINALG-wide SPD matrices
    (condition number about 5)."""
    return np.linalg.cholesky(_spd(OPS_LINALG, OPS_BATCH, rng)).astype(
        np.float32)


def _householder(rng):
    """(x, tau) of OPS_BATCH products of OPS_LINALG // 2 reflectors of
    OPS_LINALG rows, each tau = 2 / |v|^2 (v: the unit diagonal over x's
    column below it), so the product is orthogonal."""
    x = _rand(rng, OPS_BATCH, OPS_LINALG, OPS_LINALG // 2)
    below = np.tril(x, -1)
    tau = 2.0 / (1.0 + (below ** 2).sum(axis=-2))
    return [x, tau.astype(np.float32)]


def _distinct_cells(rng, n, k):
    """(rows, cols) of k distinct cells of an n x n array."""
    flat = rng.permutation(n * n)[:k]
    return (flat // n).astype(np.int64), (flat % n).astype(np.int64)


def _sorted(rng, k):
    return np.sort(_rand(rng, k))


# the recipes whose inputs are not one 2-D shape: name -> (rng, n) ->
# (inputs, attrs over the recipe's) at n = OPS_BIG[0] (OPS_BIG_BF16[0] for
# the bf16 check). Index arrays are fresh draws over the grown dims, with
# distinct targets where a duplicate would be a write race; matrices at
# linalg size are well conditioned; images are _img's.
OPS_GROWN = {
    # indexing and scatter
    "gather": lambda r, n: ([_rand(r, n, n), _ints(r, n, n)], {}),
    "gather_nd": lambda r, n: ([_rand(r, n, n), _ints(r, n, n, 1)], {}),
    "index_select": lambda r, n: ([_rand(r, n, n), _ints(r, n, n)], {}),
    "index_add": lambda r, n: ([_rand(r, n, n), _ints(r, n, n), 0,
                                _rand(r, n, n)], {}),
    "index_fill": lambda r, n: ([_rand(r, n, n), _ints(r, n, n // 2)], {}),
    "index_put": lambda r, n: ([_rand(r, n, n), _distinct_cells(
        r, n, n * n // 4), _rand(r, n * n // 4)], {}),
    "index_sample": lambda r, n: ([_rand(r, n, n), _ints(r, n, n, n // 4)],
                                  {}),
    "take": lambda r, n: ([_rand(r, n, n), _ints(r, n * n, n * n // 4)], {}),
    "take_along_axis": lambda r, n: ([_rand(r, n, n), _ints(r, n, n, n), 0],
                                     {}),
    "scatter": lambda r, n: ([_rand(r, n, n), r.permutation(n)[:n // 2]
                              .astype(np.int64), _rand(r, n // 2, n)], {}),
    "scatter_add": lambda r, n: ([_rand(r, n, n), _ints(r, n, n),
                                  _rand(r, n, n)], {}),
    "scatter_nd": lambda r, n: ([_ints(r, n, n, 1), _rand(r, n, n)],
                                {"shape": [n, n]}),
    "scatter_nd_add": lambda r, n: ([_rand(r, n, n), _ints(r, n, n, 1),
                                     _rand(r, n, n)], {}),
    "masked_scatter": lambda r, n: ([_rand(r, n, n), r.rand(n, n) > 0.5,
                                     _rand(r, n * n)], {}),
    "masked_fill": lambda r, n: ([_rand(r, n, n), r.rand(n, n) > 0.5, -1.0],
                                 {}),
    "select_scatter": lambda r, n: ([_rand(r, n, n), _rand(r, n)], {}),
    "slice_scatter": lambda r, n: ([_rand(r, n, n), _rand(r, n // 2, n)],
                                   {"ends": [n // 2]}),
    "diagonal_scatter": lambda r, n: ([_rand(r, n, n), _rand(r, n)], {}),
    "fill_diagonal_tensor": lambda r, n: ([_rand(r, n, n), _rand(r, n)], {}),
    "multiplex": lambda r, n: ([[_rand(r, n, n), _rand(r, n, n)], _ints(
        r, 2, n, 1).astype(np.int32)], {}),
    # search
    "searchsorted": lambda r, n: ([_sorted(r, 2 ** 20),
                                   _rand(r, n * n // 4)], {}),
    "bucketize": lambda r, n: ([_rand(r, n * n // 4), _sorted(r, 2 ** 20)],
                               {}),
    "isin": lambda r, n: ([_ints(r, 1000, n * n // 4).astype(np.float32),
                           _ints(r, 1000, 512).astype(np.float32)], {}),
    "unique": lambda r, n: ([_ints(r, 2 ** 16, n * n // 4).astype(
        np.float32)], {}),
    "unique_consecutive": lambda r, n: ([np.sort(_ints(
        r, 2 ** 16, n * n // 4)).astype(np.float32)], {}),
    "gather_tree": lambda r, n: ([_ints(r, SEQ2SEQ_VOCAB, 128, n // 64, 8),
                                  _ints(r, 8, 128, n // 64, 8)], {}),
    # shapes, lists and broadcasts
    "add_n": lambda r, n: ([[_rand(r, n // 2, n) for _ in range(3)]], {}),
    **{k: (lambda r, n: ([[_rand(r, n // 2, n), _rand(r, n // 2, n)]], {}))
       for k in ("concat", "stack", "hstack", "vstack", "dstack",
                 "row_stack", "column_stack")},
    "broadcast_tensors": lambda r, n: ([[_rand(r, 1, n), _rand(r, n, 1)]],
                                       {}),
    "broadcast_to": lambda r, n: ([_rand(r, 1, n)], {"shape": [n, n]}),
    "expand": lambda r, n: ([_rand(r, 1, n)], {"shape": [n, n]}),
    "expand_as": lambda r, n: ([_rand(r, 1, n), _rand(r, n, n)], {}),
    "reduce_as": lambda r, n: ([_rand(r, n, n), _rand(r, 1, n)], {}),
    "view_as": lambda r, n: ([_rand(r, n, n), _rand(r, 2 * n, n // 2)], {}),
    "reshape": lambda r, n: ([_rand(r, n, n)], {"shape": [2 * n, n // 2]}),
    "view": lambda r, n: ([_rand(r, n, n)],
                          {"shape_or_dtype": [2 * n, n // 2]}),
    "unflatten": lambda r, n: ([_rand(r, n, n)],
                               {"shape": [64, n // 64]}),
    "crop": lambda r, n: ([_rand(r, n, n)], {"shape": [n // 2, n // 2]}),
    "flatten": lambda r, n: ([_rand(r, n // 256, n // 16, n)], {}),
    "dsplit": lambda r, n: ([_rand(r, n // 256, n // 16, n)], {}),
    "squeeze": lambda r, n: ([_rand(r, n, 1, n)], {}),
    "atleast_2d": lambda r, n: ([_rand(r, n * n // 4)], {}),
    "as_complex": lambda r, n: ([_rand(r, n // 2, n, 2)], {}),
    "block_diag": lambda r, n: ([[_rand(r, n // 4, n // 4),
                                  _rand(r, n // 2, n // 8)]], {}),
    "meshgrid": lambda r, n: ([[_rand(r, n), _rand(r, n)]], {}),
    "diag": lambda r, n: ([_rand(r, n)], {}),
    "diagflat": lambda r, n: ([_rand(r, n)], {}),
    "diag_embed": lambda r, n: ([_rand(r, n // 64, n // 8)], {}),
    "kron": lambda r, n: ([_rand(r, 64, 64), _rand(r, n // 64, n // 64)],
                          {}),
    "pdist": lambda r, n: ([_rand(r, n // 2, 64)], {}),
    "cumulative_trapezoid": lambda r, n: ([_rand(r, n, n)], {}),
    "one_hot": lambda r, n: ([_ints(r, 1000, n)], {"num_classes": 1000}),
    "sequence_mask": lambda r, n: ([_ints(r, 512, n) + 1], {"maxlen": 512}),
    "shard_index": lambda r, n: ([_ints(r, 32000, 16 * n, 1)], {
        "index_num": 32000, "nshards": 8, "shard_id": 0}),
    # products and linalg: OPS_LINALG wide, OPS_BATCH of them
    "tensordot": lambda r, n: ([_rand(r, OPS_BATCH * OPS_LINALG, OPS_LINALG),
                                _rand(r, OPS_LINALG, OPS_LINALG)], {}),
    "einsum": lambda r, n: (["ij,jk->ik", _rand(
        r, OPS_BATCH * OPS_LINALG, OPS_LINALG), _rand(
        r, OPS_LINALG, OPS_LINALG)], {}),
    "multi_dot": lambda r, n: ([[_rand(r, OPS_BATCH * OPS_LINALG,
                                       OPS_LINALG),
                                 _rand(r, OPS_LINALG, OPS_LINALG),
                                 _rand(r, OPS_LINALG, OPS_LINALG // 2)]], {}),
    "cross": lambda r, n: ([_rand(r, n * n // 4, 3), _rand(r, n * n // 4, 3)],
                           {}),
    "cholesky_solve": lambda r, n: ([_rand(r, OPS_BATCH, OPS_LINALG, 64),
                                     _chol(r)], {}),
    "triangular_solve": lambda r, n: ([_chol(r), _rand(
        r, OPS_BATCH, OPS_LINALG, 64)], {}),
    "householder_product": lambda r, n: (_householder(r), {}),
    # nn: a transformer's and an image model's widths
    "linear": lambda r, n: ([_rand(r, n, n // 4), _rand(r, n // 4, n // 4)
                             * 0.03], {}),
    "bilinear": lambda r, n: ([_rand(r, n, 64), _rand(r, n, 64),
                               _rand(r, 16, 64, 64)], {}),
    "prelu": lambda r, n: ([_rand(r, n, n), np.asarray([0.25], np.float32)],
                           {}),
    "embedding": lambda r, n: ([_ints(r, 32000, n // 128, 512),
                                _rand(r, 32000, 512)], {}),
    "embedding_bag": lambda r, n: ([_ints(r, 32000, n, 4),
                                    _rand(r, 32000, 512)], {}),
    "cross_entropy": lambda r, n: ([_rand(r, n, n), _ints(r, n, n)], {}),
    "nll_loss": lambda r, n: ([np.log(r.uniform(0.05, 0.95, (n, n))).astype(
        np.float32), _ints(r, n, n)], {}),
    "softmax_with_cross_entropy": lambda r, n: ([_rand(r, n, n),
                                                 _ints(r, n, n, 1)], {}),
    "fused_linear_cross_entropy": lambda r, n: ([
        _rand(r, n // 4, 512), _rand(r, 512, 8192) * 0.05,
        _ints(r, 8192, n // 4)], {}),
    "margin_ranking_loss": lambda r, n: ([
        _rand(r, n * n // 4), _rand(r, n * n // 4),
        np.sign(_rand(r, n * n // 4)).astype(np.float32)], {}),
    "cosine_embedding_loss": lambda r, n: ([
        _rand(r, n, 512), _rand(r, n, 512),
        np.where(r.rand(n) > 0.5, 1, -1).astype(np.float32)], {}),
    "batch_norm": lambda r, n: ([_rand(r, n, 1024), np.zeros(
        1024, np.float32), np.ones(1024, np.float32)], {}),
    "layer_norm": lambda r, n: ([_rand(r, n, 1024)],
                                {"normalized_shape": [1024]}),
    "rms_norm": lambda r, n: ([_rand(r, n, n), _rand(r, n) + 1.0], {}),
    "group_norm": lambda r, n: ([_img(r, n)], {"num_groups": 8}),
    "instance_norm": lambda r, n: ([_img(r, n)], {}),
    "local_response_norm": lambda r, n: ([_img(r, n)], {}),
    "channel_shuffle": lambda r, n: ([_img(r, n)], {"groups": 8}),
    "pixel_shuffle": lambda r, n: ([_img(r, n)], {}),
    "pixel_unshuffle": lambda r, n: ([_img(r, n, 16, 112)], {}),
    "zeropad2d": lambda r, n: ([_img(r, n)], {}),
    "interpolate": lambda r, n: ([_img(r, n)], {}),
    "upsample": lambda r, n: ([_img(r, n)], {}),
    "maxout": lambda r, n: ([_img(r, n)], {}),
    "dropout2d": lambda r, n: ([_img(r, n)], {}),
    "dropout3d": lambda r, n: ([_rand(r, n // 256, 32, 16, 32, 32)], {}),
    "unfold": lambda r, n: ([_img(r, n)], {}),
    "fold": lambda r, n: ([_rand(r, n // 128, 256, 55 * 55)],
                          {"output_sizes": [56, 56]}),
    # convolutions and pools
    "conv1d": lambda r, n: ([_rand(r, n // 128, 64, 1024),
                             _rand(r, 64, 64, 3) * 0.1], {}),
    "conv1d_transpose": lambda r, n: ([_rand(r, n // 128, 64, 1024),
                                       _rand(r, 64, 64, 3) * 0.1], {}),
    "conv2d": lambda r, n: ([_img(r, n), _rand(r, 64, 64, 3, 3) * 0.1], {}),
    "conv2d_transpose": lambda r, n: ([_img(r, n, 64, 28),
                                       _rand(r, 64, 32, 3, 3) * 0.1], {}),
    "conv3d": lambda r, n: ([_rand(r, n // 512, 32, 16, 32, 32),
                             _rand(r, 32, 32, 2, 2, 2) * 0.1], {}),
    "conv3d_transpose": lambda r, n: ([_rand(r, n // 512, 32, 8, 16, 16),
                                       _rand(r, 32, 32, 2, 2, 2) * 0.1], {}),
    **{k: (lambda r, n: ([_rand(r, n // 128, 64, 4096)], {})) for k in (
        "avg_pool1d", "max_pool1d", "lp_pool1d", "adaptive_avg_pool1d",
        "adaptive_max_pool1d")},
    **{k: (lambda r, n: ([_img(r, n, 64, 112)], {})) for k in (
        "avg_pool2d", "max_pool2d", "lp_pool2d", "adaptive_avg_pool2d",
        "adaptive_max_pool2d")},
    **{k: (lambda r, n: ([_rand(r, n // 512, 32, 16, 64, 64)], {}))
       for k in ("avg_pool3d", "max_pool3d", "adaptive_avg_pool3d",
                 "adaptive_max_pool3d")},
}


def _ops_inputs(name, category, spec, rng, n=OPS_BIG[0]):
    """(inputs, attrs over the recipe's, size label): the recipe's inputs
    at the size its users run (OPS_GROWN; one 2-D shape: OPS_BIG, with
    ``n`` rows and columns; linalg OPS_LINALG, square SPD ones batched
    OPS_BATCH), else, for OPS_AT_RECIPE, as the recipe has them."""
    ins = spec["inputs"]
    arrays = [v for v in ins if isinstance(v, np.ndarray)]
    if name in OPS_FUSED:
        return OPS_FUSED[name](rng), {}, "block widths"
    if name in OPS_AT_RECIPE:
        return ins, {}, "recipe"
    if name in OPS_GROWN:
        args, attrs = OPS_GROWN[name](rng, n)
        first = next(a for a in args if isinstance(a, (np.ndarray, list)))
        first = first[0] if isinstance(first, list) else first
        return args, attrs, "x".join(str(d) for d in first.shape)
    if category == "linalg":
        # fresh draws, not the recipe's values repeated (a matrix of
        # repeated rows is singular)
        m = OPS_LINALG
        spd = [a.ndim == 2 and a.shape[0] == a.shape[1] and np.allclose(
            a, a.T, atol=1e-4) for a in arrays]
        if all(spd):
            return [_spd(m, OPS_BATCH, rng) for _ in arrays], {}, \
                f"{OPS_BATCH}x{m}x{m}"
        out = []
        for a, sym in zip(arrays, spd):
            shape = tuple(_linalg_dim(d) for d in a.shape)
            if a.dtype == np.int64:
                out.append(rng.randint(0, m, shape).astype(np.int64))
            elif sym:
                out.append(_spd(shape[0], 0, rng))
            else:
                out.append(_rand(rng, *shape))
        return out, {}, "x".join(str(d) for d in out[0].shape)
    big = (n, n)
    if name == "put_along_axis":        # distinct targets: no write race
        x, _idx, v = arrays
        perm = np.argsort(rng.rand(*big), axis=0).astype(np.int64)
        return [_grow(x, big, rng), perm, _grow(v, big, rng)], {}, \
            f"{n}x{n}"
    shapes = {a.shape for a in arrays}
    if category in OPS_BIG_CATEGORIES and len(arrays) == len(ins) \
            and len(shapes) == 1 and len(next(iter(shapes))) == 2:
        return [_grow(a, big, rng) for a in arrays], {}, f"{n}x{n}"
    raise AssertionError(f"ops: {name} ({category}) has no size to grow to: "
                         f"add it to OPS_GROWN or OPS_AT_RECIPE")


def _on(paddle, v, dev, bf16=False):
    if isinstance(v, (list, tuple)) and all(isinstance(x, np.ndarray)
                                            for x in v):
        return [_on(paddle, x, dev, bf16) for x in v]
    if isinstance(v, np.ndarray):
        t = paddle.to_tensor(v, place=dev)
        return t.astype("bfloat16") if bf16 and v.dtype == np.float32 else t
    return v


def _flat_out(out, paddle):
    if isinstance(out, paddle.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat_out(o, paddle)]
    return []


def _ops_err(name, got, ref, dtype):
    """(relative error of the float outputs, integral outputs equal),
    computed on the card."""
    g_all = [g._data.detach() for g in got]
    r_all = [r._data.detach().to(g.device) for r, g in zip(ref, g_all)]
    if name in OPS_PRODUCTS:        # the product, and S or w beside it
        keep = {"svd": [1], "qr": [], "eigh": [0]}[name]
        g_all = [OPS_PRODUCTS[name](*g_all)] + [g_all[k] for k in keep]
        r_all = [OPS_PRODUCTS[name](*r_all)] + [r_all[k] for k in keep]
    if name in OPS_UNORDERED:
        g_all, r_all = g_all[:1], r_all[:1]
    worst, same = 0.0, True
    for ga, ra in zip(g_all, r_all):
        if ga.shape != ra.shape:
            raise AssertionError(f"ops: {name} card shape {tuple(ga.shape)}"
                                 f" vs CPU {tuple(ra.shape)}")
        if ga.is_complex() or ra.is_complex() or name in OPS_SIGNED:
            ga, ra = ga.abs(), ra.abs()
        if name in OPS_UNORDERED:
            ga, ra = ga.sort(-1).values, ra.sort(-1).values
        if ga.is_floating_point():
            ga, ra = ga.double(), ra.double()
            both_nan = torch.isnan(ga) & torch.isnan(ra)
            diff = torch.where(both_nan, torch.zeros_like(ga),
                               (ga - ra).abs())
            finite = torch.where(torch.isfinite(ra), ra.abs(),
                                 torch.zeros_like(ra))
            if diff.numel():
                scale = max(float(finite.max()), 1.0)
                worst = max(worst, float(diff.max()) / scale)
        elif name in OPS_NEAR_INT:
            off = (ga.long() - ra.long()).abs()
            same = same and int(off.max()) <= 1 and \
                float((off > 0).float().mean()) <= 1e-4
        elif dtype == torch.float32:
            same = same and bool(torch.equal(ga, ra))
    return worst, same


def _ops_time(fn):
    """One call's card time in ms (CUDA events, after a warm call)."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _ops_case(paddle, fn, name, cat, args, attrs, dtype, stats, label):
    """``fn`` (op ``name`` of category ``cat``) on the card and on the
    CPU over the same inputs; adds its error and card time to ``stats``
    (one entry a category and dtype)."""
    bf16 = dtype == torch.bfloat16
    with paddle.device_guard("gpu:0"):
        card_in = [_on(paddle, v, "gpu:0", bf16) for v in args]
        # copies: an in-place op's result is its input, which the timed
        # calls below change again
        got = [paddle.Tensor(t._data.clone()) for t in _flat_out(
            fn(*card_in, **attrs), paddle)]
        ms = _ops_time(lambda: fn(*card_in, **attrs))
    with paddle.device_guard("cpu"):
        ref = _flat_out(fn(*[_on(paddle, v, "cpu", bf16) for v in args],
                           **attrs), paddle)
    if len(got) != len(ref) or not got:
        raise AssertionError(f"ops: {name} gave {len(got)} card and "
                             f"{len(ref)} CPU outputs")
    if name in OPS_RANDOM:
        err, same = 0.0, all(g.dtype == r.dtype and g.shape == r.shape
                             for g, r in zip(got, ref))
    else:
        err, same = _ops_err(name, got, ref, dtype)
    st = stats.setdefault((cat, dtype), dict(ops=set(), worst=(0.0, ""),
                                             slowest=(0.0, ""), sizes=set()))
    st["ops"].add(name)
    st["sizes"].add(label)
    st["worst"] = max(st["worst"], (err, name))
    st["slowest"] = max(st["slowest"], (ms, name))
    if err > OPS_TOL[dtype] or not same:
        raise AssertionError(f"ops: {name} ({label}, {dtype}) card vs CPU "
                             f"error {err:.3e} (limit {OPS_TOL[dtype]}), "
                             f"integral outputs equal: {same}")


def _ops_extra(case, registry, stats, rng):
    """The ops the sweep has no recipe for, at their user sizes: fft over
    OPS_FFT points, stft/istft over OPS_STFT, the geometric ops over an
    OPS_GRAPH graph, in-place ops and random draws on OPS_BIG, and the
    quantization ops."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import fft
    f32 = torch.float32

    def op(name, args, kw, label):
        d = registry.OPS[name]
        case(d.lowering, name, d.category, args, kw, f32, stats, label)

    x = rng.standard_normal(OPS_FFT).astype(np.float32)
    sq = x.reshape(1024, 1024)
    for name, arg, kw in (("fft", x, {}), ("rfft", x, {}),
                          ("ifft", x, {"norm": "ortho"}),
                          ("fft2", sq, {}), ("rfftn", sq, {}),
                          ("irfft", np.abs(x[:OPS_FFT // 2 + 1]), {})):
        case(getattr(fft, name), name, "fft", [arg], kw, f32, stats,
             f"{OPS_FFT} points")
    b, n, n_fft, hop = (OPS_STFT[k] for k in ("b", "n", "n_fft", "hop"))
    sig = rng.standard_normal((b, n)).astype(np.float32)
    win = np.hanning(n_fft).astype(np.float32)
    op("stft", [sig, n_fft, hop, n_fft, win], {}, f"{b}x{n}")
    with paddle.device_guard("cpu"):
        spec = registry.OPS["stft"].lowering(
            paddle.to_tensor(sig), n_fft, hop, n_fft,
            paddle.to_tensor(win)).numpy()
    op("istft", [spec, n_fft, hop, n_fft, win], {"length": n}, f"{b}x{n}")
    op("frame", [sig], {"frame_length": n_fft, "hop_length": hop},
       f"{b}x{n}")
    op("overlap_add", [rng.standard_normal((b, n_fft, 98)).astype(
        np.float32)], {"hop_length": hop}, f"{b}x{n_fft}x98")
    # lu_unpack has no recipe (it takes lu's pivots): lu's factors of
    # OPS_BATCH general OPS_LINALG-wide matrices
    mats = _rand(rng, OPS_BATCH, OPS_LINALG, OPS_LINALG)
    with paddle.device_guard("cpu"):
        packed = [t.numpy() for t in registry.OPS["lu"].lowering(
            paddle.to_tensor(mats))]
    op("lu_unpack", packed, {}, "x".join(str(d) for d in mats.shape))
    nodes, edges, feat = (OPS_GRAPH[k] for k in ("nodes", "edges", "feat"))
    graph = f"{nodes} nodes {edges} edges"
    feats = rng.standard_normal((nodes, feat)).astype(np.float32)
    efeat = rng.standard_normal((edges, feat)).astype(np.float32)
    src = rng.randint(0, nodes, edges).astype(np.int64)
    dst = rng.randint(0, nodes, edges).astype(np.int64)
    for name in ("segment_sum", "segment_mean", "segment_max",
                 "segment_min"):
        op(name, [efeat, np.sort(dst)], {}, graph)
    for red in ("sum", "mean", "max", "min"):
        op("send_u_recv", [feats, src, dst], {"reduce_op": red}, graph)
    op("send_ue_recv", [feats, efeat, src, dst],
       {"message_op": "mul", "reduce_op": "sum"}, graph)
    op("send_uv", [feats, feats, src, dst], {"message_op": "add"}, graph)
    order = np.argsort(dst, kind="stable")
    colptr = np.searchsorted(dst[order], np.arange(nodes + 1)).astype(
        np.int64)
    query = rng.choice(nodes, 1024, replace=False).astype(np.int64)
    # the full neighbourhoods (no draw), so the two devices agree
    op("sample_neighbors", [src[order], colptr, query], {}, graph)
    picked = 16 * 1024
    op("reindex_graph", [query, src[:picked], np.full(1024, 16, np.int64)],
       {}, graph)
    big = _grow(rng.uniform(0.2, 0.9, (3, 4)).astype(np.float32), OPS_BIG,
                rng)
    size = f"{OPS_BIG[0]}x{OPS_BIG[1]}"
    for name in ("abs_", "sin_", "cos_", "tanh_", "log_", "square_",
                 "trunc_", "neg_", "sqrt_", "exp_"):
        if name in registry.OPS:
            op(name, [big], {}, size)
        else:                            # a Tensor method without an entry
            case(getattr(paddle.Tensor, name), name, "inplace", [big], {},
                 f32, stats, size)
    # the draws are held to shapes and dtypes only: a quarter of OPS_BIG
    # (the CPU's binomial and gamma draws take seconds at 16M)
    small = big[:OPS_BIG[0] // 4, :OPS_BIG[1] // 4].copy()
    for name, args, kw in (("normal_", [small], {}),
                           ("bernoulli_", [small], {}),
                           ("log_normal_", [small], {}),
                           ("cauchy_", [small], {}),
                           ("geometric_", [small], {"probs": 0.3}),
                           ("standard_gamma", [small], {}),
                           ("poisson", [small], {}), ("bernoulli", [small], {}),
                           ("binomial", [np.full(small.shape, 10.0,
                                                 np.float32), small], {})):
        op(name, args, kw, "x".join(str(d) for d in small.shape))
    w = (rng.standard_normal((4096, 4096)) * 0.02).astype(np.float32)
    a = rng.standard_normal((64, 4096)).astype(np.float32)
    op("weight_quantize", [w], {}, "4096x4096")
    op("fake_quant", [w], {}, "4096x4096")
    op("apply_per_channel_scale", [a, np.abs(a[0]) + 1.0], {}, "64x4096")


def phase_ops(state):
    """Every recipe of the JAX package's op sweep, grown to the sizes its
    users run (OPS_BIG; linalg OPS_LINALG, batched OPS_BATCH where square)
    where the op allows, on the card against the same op on the CPU in
    fp32, and in bf16 where the sweep has a bf16 case; then the ops the
    sweep has no recipe for (_ops_extra). One line a category: ops run,
    worst error, slowest op in ms."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import registry
    card = _card_line()
    recipes, bf16_skip = _sweep_recipes()
    rng = np.random.RandomState(5)
    stats = {}
    sized = {}
    failed = []
    t0 = time.perf_counter()

    walls = []

    def case(*args):
        """One ``_ops_case``; a failure is kept, and the phase fails once
        every op has run."""
        t = time.perf_counter()
        try:
            _ops_case(paddle, *args)
        except Exception as e:      # noqa: BLE001 - reported below
            failed.append(f"{args[1]} {args[5]}: {type(e).__name__}: "
                          f"{str(e)[:300]}")
        walls.append((time.perf_counter() - t, args[1], str(args[5])))
    for name in sorted(recipes):
        if name not in registry.OPS:
            continue
        spec = recipes[name]
        cat = registry.OPS[name].category
        args, grown, label = _ops_inputs(name, cat, spec, rng)
        attrs = dict(spec["attrs"], **OPS_FUSED_ATTRS.get(name, {}),
                     **grown)
        sized[name] = label
        fn = registry.OPS[name].lowering
        case(fn, name, cat, args, attrs, torch.float32, stats, label)
        eligible = spec["jit"] and all(
            isinstance(v, np.ndarray) and v.dtype == np.float32
            for v in spec["inputs"]) and name not in bf16_skip
        if eligible:
            if label != "block widths":     # OPS_BIG_BF16 rows and columns
                args, grown, label = _ops_inputs(name, cat, spec, rng,
                                                 OPS_BIG_BF16[0])
                attrs = dict(spec["attrs"], **grown)
            case(fn, name, cat, args, attrs, torch.bfloat16, stats, label)
    _ops_extra(case, registry, stats, rng)
    for (cat, dtype), st in sorted(stats.items(), key=lambda kv: (
            kv[0][0], str(kv[0][1]))):
        log(json.dumps({"ops": cat, "dtype": str(dtype).replace(
            "torch.", ""), "ops_run": len(st["ops"]), "sizes": sorted(
            st["sizes"]), "worst_error": st["worst"][0],
            "worst_op": st["worst"][1], "slowest_ms": st["slowest"][0],
            "slowest_op": st["slowest"][1], "card": card}))
    small = sorted(n for n, lab in sized.items() if lab == "recipe")
    run = set().union(*(st["ops"] for st in stats.values()))
    log(f"ops: {len(run)} ops run; {len(sized)} recipes, "
        f"{len(sized) - len(small)} grown, {len(small)} at the recipe's "
        f"size: {' '.join(small)}; {time.perf_counter() - t0:.1f} s; the "
        f"slowest cases, card and CPU: " + ", ".join(
            f"{nm} {dt.replace('torch.', '')} {w:.2f} s"
            for w, nm, dt in sorted(walls, reverse=True)[:10]))
    torch.cuda.empty_cache()
    if failed:
        for line in failed:
            log(f"ops: FAILED {line}")
        raise AssertionError(f"ops: {len(failed)} cases failed")


# ----------------------------------------------------------- control flow
# the JAX package's worked example (tests/test_control_flow.py
# TestGreedyDecode: a greedy decode as one while_loop over KV-cache state
# under to_static(full_graph=True)) at Transformer-base width: SEQ2SEQ's
# model, B32 over a 128-token source, up to SEQ2SEQ_NEW tokens
CF_BATCH = dict(b=32, s=128)
CF_SEEDS = (999, 1001)      # the two source batches


def _cf_limits(b, n_new):
    """The second batch's per-row length limits: spread over
    [n_new // 4, 3 * n_new // 4), so its rows stop at different steps
    and the loop at another step than the recording's n_new."""
    return np.array([n_new // 4 + (r * 37) % (n_new // 2) for r in range(b)],
                    np.int64)


def _cf_step(paddle, model, static_kv, st, end, limit, n_new):
    """One greedy step over the carried state: the target token's
    embedding, each decoder layer (self-attention over its fixed-size K/V
    buffer, masked to the steps so far: the plain path; cross-attention
    to the memory's keys and values, unmasked: K1 at one query row), the
    final norm and the tied projection. A row is done once it has
    emitted ``end`` or reached its length limit (``limit``, one a row),
    and then emits ``end``. Returns (new state, logits). Paddle-API ops
    only, so it is traced and replayed inside the op."""
    F = paddle.nn.functional
    d = SEQ2SEQ["d_model"]
    b = st["tok"].shape[0]
    step = st["step"]
    slot = paddle.arange(n_new) == step                  # this step's row
    seen = (paddle.arange(n_new) <= step).reshape([1, 1, 1, n_new])
    x = (F.embedding(st["tok"].reshape([b, 1]), model.embed.weight)
         * (d ** 0.5) + paddle.gather(model.pos, step.reshape([1])))
    write = slot.reshape([1, n_new, 1, 1])
    ks, vs = [], []
    for i, layer in enumerate(model.transformer.decoder.layers):
        sa = layer.self_attn
        q = sa._reshape_heads(sa.q_proj(x))
        k = paddle.where(write, sa._reshape_heads(sa.k_proj(x)), st["k"][i])
        v = paddle.where(write, sa._reshape_heads(sa.v_proj(x)), st["v"][i])
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=seen,
                                           training=False)
        x = layer.norm1(x + sa.out_proj(a.reshape([b, 1, d])))
        x = layer.norm2(x + layer.cross_attn(x, None, None, None,
                                             static_kv[i]))
        x = layer.norm3(x + layer.linear2(layer.activation(
            layer.linear1(x))))
        ks.append(k)
        vs.append(v)
    if model.transformer.decoder.norm is not None:
        x = model.transformer.decoder.norm(x)
    logits = model.logits(x)[:, 0]
    nxt = paddle.where(st["done"], end, paddle.argmax(logits, axis=-1))
    ids = paddle.where(slot.reshape([1, n_new]), nxt.reshape([b, 1]),
                       st["ids"])
    done = paddle.logical_or(st["done"], paddle.logical_or(
        nxt == end, step + 1 >= limit))
    return {"step": step + 1, "tok": nxt, "k": ks, "v": vs, "ids": ids,
            "done": done}, logits


def _cf_start(paddle, model, src, n_new):
    """(the memory's cross-attention caches, the initial state)."""
    from paddle_tpu_torch.nn import MultiHeadAttention
    memory = model.transformer.encoder(model.tokens(src))
    layers = model.transformer.decoder.layers
    static_kv = [layer.cross_attn.gen_cache(
        memory, memory, MultiHeadAttention.StaticCache) for layer in layers]
    b = src.shape[0]
    heads = SEQ2SEQ["nhead"]
    shape = [b, n_new, heads, SEQ2SEQ["d_model"] // heads]
    state = {"step": paddle.zeros([], "int64"),
             "tok": paddle.zeros([b], "int64"),
             "k": [paddle.zeros(shape, memory.dtype) for _ in layers],
             "v": [paddle.zeros(shape, memory.dtype) for _ in layers],
             "ids": paddle.zeros([b, n_new], "int64"),
             "done": paddle.zeros([b], "bool")}
    return static_kv, state


def _cf_decoder(paddle, model, n_new):
    """decode(src, end, limit) -> (ids (B, n_new), steps run): the
    encoder, then one ``static.nn.while_loop`` over the state until every
    row is done (``_cf_step``) or n_new steps."""
    def decode(src, end, limit):
        static_kv, state = _cf_start(paddle, model, src, n_new)

        def keep(st):
            return paddle.logical_and(
                st["step"] < n_new, paddle.logical_not(paddle.all(
                    st["done"])))

        def body(st):
            return [_cf_step(paddle, model, static_kv, st, end, limit,
                             n_new)[0]]

        final = paddle.static.nn.while_loop(keep, body, [state])[0]
        return final["ids"], final["step"]
    return decode


def _cf_host_loop(paddle, model, src, end, limit, n_new):
    """The same step in a Python loop, the stop read on the host each
    step: (ids, steps, each row's top-two logit gap a step)."""
    static_kv, st = _cf_start(paddle, model, src, n_new)
    gaps = []
    while int(st["step"]) < n_new and not bool(paddle.all(st["done"])):
        st, logits = _cf_step(paddle, model, static_kv, st, end, limit,
                              n_new)
        top = paddle.topk(logits.astype("float32"), 2, axis=-1)[0].numpy()
        gaps.append(top[:, 0] - top[:, 1])
    return st["ids"].numpy(), int(st["step"]), np.stack(gaps, axis=1)


def _cf_want_steps(ids, tok, limits):
    """The steps the loop runs with end token ``tok`` and per-row
    ``limits``, from ``ids`` decoded with neither: each row stops at its
    first ``tok`` or at its limit, the loop at its last row."""
    ends = []
    for row, lim in zip(ids, limits):
        hit = np.flatnonzero(row == tok)
        ends.append(min(int(hit[0]) + 1, int(lim)) if hit.size else int(lim))
    return max(ends), ends


def phase_control_flow(state):
    """A greedy decode as one while_loop under to_static(full_graph=True)
    at Transformer-base width in bf16: one recording and no graph break,
    the replayed ids equal to the same function run eagerly and to a
    host loop over the same step (near ties excepted), a second batch
    whose rows stop at different steps, and its loop at another step,
    replaying the same recording, K1's
    launches a token step equal to the eager run's; bf16 ms a token and
    host syncs a token."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    card = _card_line()
    n_new = SEQ2SEQ_NEW
    layers = SEQ2SEQ["num_decoder_layers"]
    with paddle.device_guard("gpu:0"), paddle.no_grad():
        model = _seq2seq_model(paddle, dropout=0.0)
        model.eval()
        model.to(dtype="bfloat16")
        # batch 0: no end token and no limit below n_new, so the loop runs
        # to n_new steps (the recording). Batch 1: other sources, each row
        # its own length limit (_cf_limits), and a token some row emits
        # first as the end token, so the rows that emit it stop at once and
        # the others at their limits, and the loop stops at another step.
        # (Greedy rows
        # of the random model repeat their first token, so no end token
        # alone can stop a row at a later step.)
        b = CF_BATCH["b"]
        src_a, _ = _seq2seq_batch(paddle, CF_SEEDS[0], **CF_BATCH)
        src_b, _ = _seq2seq_batch(paddle, CF_SEEDS[1], **CF_BATCH)
        never = paddle.to_tensor(np.int64(-1))
        no_limit = paddle.to_tensor(np.full(b, n_new, np.int64))
        ids_b, _, _ = _cf_host_loop(paddle, model, src_b, never, no_limit,
                                    n_new)
        limits_b = _cf_limits(b, n_new)
        # the end token: the rarest first token of the batch's rows (the
        # rows that emit it stop at once, the others at their limits)
        firsts = ids_b[:, 0].tolist()
        tok_b = int(min(firsts, key=lambda t: (firsts.count(t),
                                               firsts.index(t))))
        steps_b, ends_b = _cf_want_steps(ids_b, tok_b, limits_b)
        if not n_new // 4 <= steps_b < n_new or len(set(ends_b)) < 2:
            raise AssertionError(
                f"control_flow: batch 1 would stop at step {steps_b}, its "
                f"rows at {sorted(set(ends_b))}: wants a stop in "
                f"[{n_new // 4}, {n_new}) and rows stopping at different "
                f"steps")
        batches = [(src_a, -1, no_limit, n_new),
                   (src_b, tok_b, paddle.to_tensor(limits_b), steps_b)]
        decode = _cf_decoder(paddle, model, n_new)
        static = paddle.jit.to_static(decode, full_graph=True)
        rows = []
        for k, (src, tok, limit, want_steps) in enumerate(batches):
            end = paddle.to_tensor(np.int64(tok))
            if k == 0:
                static(src, end, limit)             # the recording
            torch.cuda.synchronize()
            before = fa.flash_attention_fwd.launches
            t0 = time.perf_counter()
            ids_s, steps_s = static(src, end, limit)
            ids_s, steps_s = ids_s.numpy(), int(steps_s)
            wall = time.perf_counter() - t0
            replay_k1 = fa.flash_attention_fwd.launches - before
            before = fa.flash_attention_fwd.launches
            ids_e, steps_e = decode(src, end, limit)
            ids_e, steps_e = ids_e.numpy(), int(steps_e)
            eager_k1 = fa.flash_attention_fwd.launches - before
            ids_h, steps_h, gaps = _cf_host_loop(paddle, model, src, end,
                                                 limit, n_new)
            syncs = _cf_syncs(lambda: static(src, end, limit)[0].numpy())
            log(f"control_flow: batch {k} end token {tok}: steps replay "
                f"{steps_s} eager {steps_e} host loop {steps_h} (want "
                f"{want_steps}); K1 launches replay {replay_k1} eager "
                f"{eager_k1}")
            if not steps_s == steps_e == steps_h == want_steps:
                raise AssertionError(
                    f"control_flow: batch {k} ran {steps_s}/{steps_e}/"
                    f"{steps_h} steps, wants {want_steps}")
            for label, got in (("replay vs host loop", ids_s),
                               ("eager vs host loop", ids_e)):
                _hold(f"control_flow batch {k} {label}",
                      [list(r[:steps_h]) for r in got],
                      [list(r[:steps_h]) for r in ids_h],
                      lambda i, j: float(gaps[i, j]))
            want_k1 = SEQ2SEQ["num_encoder_layers"] + layers * steps_s
            if not replay_k1 == eager_k1 == want_k1:
                raise AssertionError(
                    f"control_flow: K1 launched {replay_k1} (replay) and "
                    f"{eager_k1} (eager) times, wants {want_k1}")
            rows.append({"batch": k, "end_token": tok, "steps": steps_s,
                         "row_stop_steps": sorted(set(ends_b)) if k
                         else [n_new],
                         "ms_a_token": wall / steps_s * 1e3,
                         "host_syncs_a_token": syncs / steps_s,
                         "k1_launches": replay_k1,
                         "k1_a_token_step": (replay_k1 - SEQ2SEQ[
                             "num_encoder_layers"]) / steps_s})
        programs = [p for p, _ in static._programs.values()]
        loops = [[st.name for st in p.steps].count("while_loop")
                 for p in programs]
        log(f"control_flow: {len(programs)} recording(s), while_loop ops "
            f"{loops}, {len(programs[0].steps)} recorded ops, graph break "
            f"{static.graph_break_reason}")
        if len(programs) != 1 or loops != [1] \
                or static.graph_break_reason is not None:
            raise AssertionError("control_flow: wants one recording with one "
                                 "while_loop op and no graph break")
        log(json.dumps({"control_flow": f"transformer_base bf16 while_loop "
                        f"greedy decode B{CF_BATCH['b']} S{CF_BATCH['s']} "
                        f"+{n_new}", "card": card, "batches": rows}))
        del model, static
    torch.cuda.empty_cache()


def _cf_syncs(fn) -> int:
    """The host syncs one call of ``fn`` makes, as torch's sync debug
    mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


# ------------------------------------------------------------ distributed
# the tiny GPT of the JAX package's TestDistBase (tests/dist_train_worker.py)
DIST_TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                 max_seq_len=16)
DIST_TINY_BATCH = 8
DIST_PARITY_STEPS = 6
DIST_PARITY_TOL = 2e-4      # tests/test_multiproc_train.py:128-132
DIST_PARITY_LR = 1e-2
# GPT-2 345M's attention on a rank of dp2 x mp2 at a global batch of 8
DIST_TP_SHAPE = dict(b=4, s=1024, h=8, d=64)
DIST_PADDED = ((2, 300, 4, 32), (2, 300, 4, 96))    # (B, S, H, d)
DIST_BATCH = 8              # bench.py's rung batch, a card for dp
DIST_STEPS = 10             # timed, after DIST_WARMUP
DIST_WARMUP = 2
BUS_BW_BYTES = 256 * 2 ** 20
BUS_BW_ITERS = 20
DIST_TIMEOUT = 840
DRILL_TIMEOUT = 10          # the drill's watchdog, seconds without progress
DRILL_LAUNCH_TIMEOUT = 120  # the drill's launch
_FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
          "flash_attention_bwd_dkv")


def _dist_mesh(n):
    """(dp, mp) of the collectives' mesh on ``n`` ranks."""
    mp = 2 if n % 2 == 0 else 1
    return n // mp, mp


def _dist_data(rank, rows, dtype):
    """Rank ``rank``'s integer-valued tensor (rows, 3) on its card."""
    base = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
    return (torch.remainder(base, 7) - 3 + rank).to(dtype).cuda()


def _dist_expected(name, members, i, rows, dtype):
    """What group rank ``i`` of ``members`` (global ranks, group order)
    must hold after collective ``name``, on the host."""
    xs = [_dist_data(m, rows, dtype).cpu() for m in members]
    n = len(members)
    chunk = lambda t, j: t.chunk(n, 0)[j]
    stack = torch.stack(xs).float()
    table = {
        "all_reduce.sum": lambda: stack.sum(0),
        "all_reduce.max": lambda: stack.amax(0),
        "all_reduce.min": lambda: stack.amin(0),
        "all_reduce.prod": lambda: stack.prod(0),
        "all_reduce.avg": lambda: stack.sum(0) / n,
        "all_gather": lambda: stack,
        "reduce_scatter": lambda: chunk(stack.sum(0), i),
        "broadcast": lambda: xs[-1],
        "reduce": lambda: stack.sum(0),
        "scatter": lambda: chunk(xs[0], i),
        "alltoall": lambda: torch.cat([chunk(x, i) for x in xs]),
        "ring": lambda: xs[(i - 1) % n],
    }
    return table[name]().to(dtype)


def _dist_collectives(dist, mesh, rank):
    """Every collective on the world and on each axis group, fp32 and
    bf16 on integer-valued data: each rank's result exactly equal to the
    host's; returns the count of checks."""
    groups = {"world": dist.get_default_group()}
    for axis in mesh.axis_names:
        groups[axis] = mesh.group((axis,))
    checks, bad = 0, []
    for dtype in (torch.float32, torch.bfloat16):
        for gname, g in groups.items():
            n, i, members = g.nranks, g.rank, g.ranks
            rows = 4 * n
            x = _dist_data(rank, rows, dtype)
            got = {}
            for op in ("sum", "max", "min", "prod", "avg"):
                t = x.clone()
                dist.all_reduce(t, op=op, group=g)
                got[f"all_reduce.{op}"] = t
            parts = []
            dist.all_gather(parts, x, group=g)
            got["all_gather"] = torch.stack(parts)
            got["reduce_scatter"] = dist.reduce_scatter(None, x.clone(),
                                                        group=g)
            t = x.clone()
            dist.broadcast(t, src=members[-1], group=g)
            got["broadcast"] = t
            t = x.clone()
            dist.reduce(t, dst=members[0], group=g)
            if i == 0:
                got["reduce"] = t
            t = torch.empty_like(x.chunk(n, 0)[0])
            dist.scatter(t, list(x.chunk(n, 0)) if i == 0 else None,
                         src=members[0], group=g)
            got["scatter"] = t
            outs = []
            dist.alltoall(outs, [c.contiguous() for c in x.chunk(n, 0)],
                          group=g)
            got["alltoall"] = torch.cat(outs)
            single = dist.alltoall_single(None, x.clone(), group=g)
            if n > 1:
                recv = torch.empty_like(x)
                for task in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, x, members[(i + 1) % n], g),
                        dist.P2POp(dist.irecv, recv, members[(i - 1) % n],
                                   g)]):
                    task.wait()
                got["ring"] = recv
                if gname != "world":
                    shifted = dist.shift_along_axis(x, gname, 1, mesh)
                    if not torch.equal(shifted.cpu(), recv.cpu()):
                        bad.append(f"{gname} shift {dtype}")
            if not torch.equal(single.cpu(), got["alltoall"].cpu()):
                bad.append(f"{gname} alltoall_single {dtype}")
            objs = []
            dist.all_gather_object(objs, (rank, i), group=g)
            if objs != [(m, k) for k, m in enumerate(members)]:
                bad.append(f"{gname} all_gather_object {objs}")
            olist = [rank]
            dist.broadcast_object_list(olist, src=members[0], group=g)
            if olist != [members[0]]:
                bad.append(f"{gname} broadcast_object_list {olist}")
            dist.barrier(g)
            for name, t in got.items():
                want = _dist_expected(name, members, i, rows, dtype)
                checks += 1
                if not torch.equal(t.cpu(), want):
                    bad.append(f"{gname} {name} {dtype}: max diff "
                               f"{(t.cpu().float() - want.float()).abs().max()}")
    if bad:
        raise AssertionError(f"rank {rank}: collectives disagree: {bad}")
    return checks


def _dist_bus_bandwidth(dist, n):
    """all_reduce of BUS_BW_BYTES fp32 over the world: (median ms,
    algorithm GB/s, bus GB/s) by CUDA events; bus = alg * 2(n-1)/n."""
    x = torch.ones(BUS_BW_BYTES // 4, device="cuda")
    ms, q1, q3 = time_ms(lambda: dist.all_reduce(x), iters=BUS_BW_ITERS,
                         warmup=5)
    alg = BUS_BW_BYTES / (ms / 1e3) / 1e9
    return {"bytes": BUS_BW_BYTES, "ms": ms, "ms_q1": q1, "ms_q3": q3,
            "algbw_gb_s": alg,
            "busbw_gb_s": alg * 2 * (n - 1) / n if n > 1 else None}


def _dist_tiny_shapes(n):
    """(B, S, H, d) of every attention the parity run gives K1-K3 on
    ``n`` ranks: the one-card run's, and each strategy's (its rows of the
    batch, its heads)."""
    t = DIST_TINY
    d = t["hidden_size"] // t["num_heads"]
    shapes = {(DIST_TINY_BATCH, t["max_seq_len"], t["num_heads"], d)}
    for hybrid in _dist_strategies(n)[0].values():
        shards = hybrid.get("dp_degree", 1) * hybrid.get("sharding_degree", 1)
        shapes.add((DIST_TINY_BATCH // shards, t["max_seq_len"],
                    t["num_heads"] // hybrid.get("mp_degree", 1), d))
    return sorted(shapes)


def _dist_kernels(rank, n):
    """K1-K3 on this rank's card, held against their plain versions at the
    TP shape (bf16, q/k/v views of one projection), at the padded head
    dims (fp32 and bf16) and at the tiny GPT's shapes of the parity run
    on ``n`` ranks (d=16, fp32, causal, views); then timed at the TP
    shape. Not counted."""
    import paddle_tpu_torch.ops.cuda.flash_attention as fa
    counts = _counts()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4242 + rank)
    t = DIST_TP_SHAPE
    cases = [(t["b"], t["s"], t["h"], t["d"], torch.bfloat16, True)]
    cases += [(*shape, dtype, False) for shape in DIST_PADDED
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [(*shape, torch.float32, True) for shape in _dist_tiny_shapes(n)]
    held = []
    for b, s, h, d, dtype, strided in cases:
        fwd_tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        err, lse_err, _ = _kernel_case(fa, b, s, s, h, d, True, strided,
                                       dtype, gen)
        q, k, v, do = _bwd_inputs(b, s, s, h, d, dtype, gen, strided)
        errs, blind = _bwd_case(fa, q, k, v, do, True)
        bwd = [e[0] if dtype == torch.float32 else e[1] for e in errs]
        label = f"B{b} S{s} H{h} d{d} {str(dtype)[6:]}"
        held.append({"shape": label, "k1_err": err, "k1_lse_err": lse_err,
                     "k2_k3_err": max(bwd)})
        if not (err <= fwd_tol and lse_err <= fwd_tol
                and max(bwd) <= BWD_LIMITS[dtype]):
            raise AssertionError(f"rank {rank}: K1-K3 disagree with their "
                                 f"plain versions at {label}: {held[-1]}")
    timed = {"flash_attention_fwd": _time_fwd(fa, gen, t)}
    timed.update(_time_bwd(fa, gen, t))
    for name, n in counts.items():
        _wrapper(name).launches = n
    return held, timed


def _dist_strategies(n):
    """name -> hybrid_configs of the strategies this world runs, and the
    names of those it needs more cards for."""
    out = {f"dp{n}": {"dp_degree": n}}
    if n >= 2 and n % 2 == 0:
        out[f"dp{n // 2}_mp2"] = {"dp_degree": n // 2, "mp_degree": 2}
        out[f"dp{n // 2}_sharding2"] = {"dp_degree": n // 2,
                                        "sharding_degree": 2}
    need = [name for name in ("dp_mp2", "dp_sharding2") if n < 2]
    return out, need


def _dist_fleet(fleet, hybrid):
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = hybrid
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _data_shard(hcg):
    """(index, count) of this rank's share of the global batch: its
    coordinate over the axes that see different data (dp, sharding)."""
    ns = hcg.get_sharding_parallel_world_size()
    return (hcg.get_data_parallel_rank() * ns
            + hcg.get_sharding_parallel_rank(),
            hcg.get_data_parallel_world_size() * ns)


def _dist_parity(dist, fleet, n):
    """The tiny fp32 GPT (d=16: K1-K3 on zero-padded copies) trained
    DIST_PARITY_STEPS AdamW steps on one card (every rank alone, the
    whole batch) and under each strategy (this rank's rows), from the
    same seeded weights: the mean loss over the ranks within
    DIST_PARITY_TOL of the card's, every step launching K1-K3 once a
    layer."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    batch = torch.from_numpy(np.random.RandomState(0).randint(
        0, DIST_TINY["vocab_size"], (DIST_TINY_BATCH,
                                     DIST_TINY["max_seq_len"]))).cuda()
    want = _flash_launches(DIST_TINY["num_layers"])

    def run(model, opt, ids):
        return [float(_train_step(model, opt, ids, *want))
                for _ in range(DIST_PARITY_STEPS)]
    single = GPTForCausalLM(GPTConfig(**DIST_TINY), device="cuda", seed=9)
    ref = run(single, AdamW(learning_rate=DIST_PARITY_LR,
                            parameters=single.named_parameters()), batch)
    strategies, need = _dist_strategies(n)
    rows = {}
    for name, hybrid in strategies.items():
        hcg = _dist_fleet(fleet, hybrid)
        model = GPTForCausalLM(GPTConfig(
            mp_degree=hcg.get_model_parallel_world_size(), **DIST_TINY),
            device="cuda", seed=9)
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=DIST_PARITY_LR,
            parameters=model.named_parameters()))
        index, shards = _data_shard(hcg)
        per = DIST_TINY_BATCH // shards
        losses = run(model, opt, batch[index * per:(index + 1) * per])
        every = []
        dist.all_gather_object(every, losses)
        mean = np.mean(every, axis=0)
        diff = float(np.abs(mean - np.asarray(ref)).max())
        rows[name] = {"max_abs_diff_to_one_card": diff,
                      "losses_mean_over_ranks": mean.tolist()}
        if not diff <= DIST_PARITY_TOL:
            raise AssertionError(f"parity {name}: {mean} against one card's "
                                 f"{ref} (max diff {diff})")
    return {"one_card_losses": ref, "strategies": rows,
            "need_more_cards": need, "tolerance": DIST_PARITY_TOL}


def _dist_rung(dist, fleet, label, hybrid, batch_a_rank, card,
               profile=False):
    """GPT-2 345M (bf16 weights, fp32 masters, bench.py's AdamW, O1) for
    DIST_WARMUP + DIST_STEPS steps on this rank's batch, under ``hybrid``
    (None: alone on this card, no fleet). Returns this rank's row and
    its launches. With ``profile`` every rank takes one more step, rank
    0 under torch.profiler (the row gets its device-busy share and its
    device time by group)."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_medium
    s = TRAIN_SHAPE["s"]
    mp = 1 if hybrid is None else hybrid.get("mp_degree", 1)
    hcg = None if hybrid is None else _dist_fleet(fleet, hybrid)
    cfg = gpt2_medium(mp_degree=mp)
    model = GPTForCausalLM(cfg, device="cuda", dtype="bfloat16",
                           seed=5).train()
    opt = _rung_adamw(model)
    flops_per_token = model.flops_per_token()
    if hcg is not None:
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
        index, _ = _data_shard(hcg)
    else:
        index = 0
    batches = _rung_batches(cfg.vocab_size, batch_a_rank, s, 100 + 2 * index)
    fwd, bwd = _flash_launches(cfg.num_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = _counts()
    walls, losses = [], []
    for k in range(DIST_WARMUP + DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _train_step(model, opt, batches[k % 2], fwd, bwd, amp_kw=O1)
        torch.cuda.synchronize()
        if k >= DIST_WARMUP:
            walls.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
    launched = _launched(c0, _counts())
    prof = None
    if profile:
        step = lambda: _train_step(model, opt, batches[0], fwd, bwd,
                                   amp_kw=O1)
        if torch.distributed.get_rank() == 0:
            prof = _profile(f"{label} step", step, groups={
                "K1-K3 attention": ("flash_fwd", "dq_", "dkv_"),
                "NCCL": ("nccl",),
                "cuBLAS GEMM": ("nvjet", "xmma", "cutlass", "cublas",
                                "gemm"),
                "elementwise and reductions": ("elementwise", "reduce",
                                               "vectorized")})
        else:
            step()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    q1, median, q3 = statistics.quantiles(walls, n=4)
    world = 1 if hcg is None else dist.get_world_size()
    shards = 1 if hcg is None else _data_shard(hcg)[1]
    tokens = batch_a_rank * s * shards          # the global batch
    row = {"distributed": label, "card": card, "world": world,
           "hybrid": hybrid, "global_batch": batch_a_rank * shards,
           "seq": s, "step_ms": median * 1e3, "step_ms_q1": q1 * 1e3,
           "step_ms_q3": q3 * 1e3, "tokens_per_s": tokens / median,
           "mfu_a_card": flops_per_token * tokens / median / world
           / BF16_FLOP_PER_S,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_over_steps": launched,
           "reducer_buckets": getattr(model, "bucket_count", None),
           "loss_first": losses[0], "loss_last": losses[-1]}
    if prof is not None:
        row["profiled_step"] = {k: prof[k] for k in (
            "wall_s", "device_busy_s", "device_busy_share",
            "host_kernel_launches", "groups")}
    del model, opt, batches
    torch.cuda.empty_cache()
    return row, launched


def _dist_rank(outdir, profile=False):
    """One rank of the distributed phase (run by the port's launcher)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    dist.init_parallel_env()
    rank, n = dist.get_rank(), dist.get_world_size()
    backend = torch.distributed.get_backend()
    if backend != "nccl" or n != int(os.environ["WORLD_SIZE"]):
        raise AssertionError(f"rank {rank}: backend {backend}, world {n}")
    card = _card_line()
    out = {"rank": rank, "world": n, "device": torch.cuda.current_device(),
           "device_name": torch.cuda.get_device_name()}
    dp, mp = _dist_mesh(n)
    mesh = dist.build_mesh({"dp": dp, "mp": mp})
    t0 = time.perf_counter()
    out["collective_checks"] = _dist_collectives(dist, mesh, rank)
    out["collectives_s"] = time.perf_counter() - t0
    out["bus_bandwidth"] = _dist_bus_bandwidth(dist, n)
    out["kernels_held"], out["kernels_timed"] = _dist_kernels(rank, n)
    dist.barrier()
    # the main path: every launch from here on counts
    for name in KERNELS:
        _wrapper(name).launches = 0
    t0 = time.perf_counter()
    out["parity"] = _dist_parity(dist, fleet, n)
    out["parity_s"] = time.perf_counter() - t0
    rungs = {}
    if n > 1:
        rungs["one_card"], _ = _dist_rung(dist, fleet, "gpt2_medium one "
                                          "card", None, DIST_BATCH, card,
                                          profile)
    rungs["dp"], _ = _dist_rung(dist, fleet, f"gpt2_medium dp{n}",
                                {"dp_degree": n}, DIST_BATCH, card, profile)
    if n >= 2 and n % 2 == 0:
        rungs["dp_mp"], _ = _dist_rung(
            dist, fleet, f"gpt2_medium dp{n // 2} x mp2 (bench.py "
            f"_bench_spmd_auto's fleet leg)",
            {"dp_degree": n // 2, "mp_degree": 2}, DIST_BATCH // (n // 2),
            card, profile)
    out["rungs"] = rungs
    out["launches"] = _counts()
    dist.barrier()
    out["flight"] = _dist_flight(dist, rank, n)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _dist_flight(dist, rank, n):
    """Every rank dumps its collective flight record (the launch sets
    PADDLE_TPU_FLIGHT_RECORD) after the phase's last collective; rank 0
    diffs the world's dumps: in sync, with every group's last sequence
    number equal over the ranks that issued in it. The dumps go to
    ``<record>.end``, where no exit dump writes over them."""
    from paddle_tpu_torch.observability import flight
    base = os.environ[flight.RECORD_ENV] + ".end"
    flight.dump(path=flight.record_path(base, rank), reason="phase end")
    dist.barrier()
    if rank != 0:
        return None
    dumps = flight.load_dumps(base, world=n)
    verdict = flight.diff_ranks(dumps, world=n)
    last = {}
    for r, per in verdict["per_rank"].items():
        for g, seq in per.items():
            if seq >= 0:
                last.setdefault(g, set()).add(seq)
    row = {"status": verdict["status"], "detail": verdict["detail"],
           "dumps": len(dumps),
           "records_a_rank": {r: len(d["entries"])
                              for r, d in dumps.items()},
           "groups_last_seq": {g: sorted(v) for g, v in last.items()}}
    if verdict["status"] != "ok" or len(dumps) != n or any(
            len(v) != 1 for v in last.values()):
        raise AssertionError(f"distributed: the flight diff {row}")
    return row


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_distributed(state):
    """paddle_tpu_torch.distributed on NCCL: every card a rank through the
    port's launcher (module docstring). The ranks' K1-K3 launches over
    their main path are added to the main path's."""
    from paddle_tpu_torch.ops.cuda import _build
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    log("distributed: nvidia-smi topo -m\n"
        + (topo.stdout + topo.stderr).rstrip())
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j)
              for j in range(n)] for i in range(n)]
    log(f"distributed: peer access (torch.cuda.can_device_access_peer) "
        f"{peers}")
    card = _card_line()
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    log(f"distributed: {n} card(s), NCCL {nccl}, {card}")
    # build once here, before the ranks start (they find the libraries)
    _build.build_all(["flash_attention_fwd", "flash_attention_bwd"])
    outdir = tempfile.mkdtemp(prefix="chip_smoke_distributed_")
    logdir = os.path.join(outdir, "log")
    try:
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc_per_node", str(n), "--master",
               f"127.0.0.1:{_free_port()}", "--log_dir", logdir,
               "--abort_grace", "30", os.path.abspath(__file__),
               "--dist-rank", outdir] + (["--profile"] if
                                         state.get("profile") else [])
        proc = subprocess.run(cmd, cwd=os.path.dirname(
            os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=DIST_TIMEOUT, env=dict(
                os.environ, PADDLE_TPU_FLIGHT_RECORD=os.path.join(
                    outdir, "flight.json")))
        if state.get("profile"):
            with open(os.path.join(logdir, "workerlog.0")) as f:
                log("--- rank 0's log (its profiles)\n" + "\n".join(
                    line for line in f.read().splitlines()
                    if not line.startswith("{")))
        if proc.returncode != 0:
            for name in sorted(os.listdir(logdir)):
                with open(os.path.join(logdir, name)) as f:
                    log(f"--- {name} (last 3000 characters)\n"
                        + f.read()[-3000:])
            raise AssertionError(f"distributed: the launch ended with "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        ranks = []
        for r in range(n):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    devices = sorted(r["device"] for r in ranks)
    if devices != list(range(n)):
        raise AssertionError(f"distributed: ranks on cards {devices}")
    r0 = ranks[0]
    log(json.dumps({"distributed": "collectives", "card": card, "world": n,
                    "nccl": nccl, "mesh": dict(zip(("dp", "mp"),
                                                   _dist_mesh(n))),
                    "checks_a_rank": [r["collective_checks"] for r in ranks],
                    "exact": True, "dtypes": ["float32", "bfloat16"],
                    "seconds_rank0": r0["collectives_s"]}))
    log(json.dumps({"distributed": "all_reduce bus bandwidth", "card": card,
                    "world": n, **r0["bus_bandwidth"]}))
    log(json.dumps({"distributed": "K1-K3 at the TP shape, the padded "
                    "head dims and the parity run's shapes, every rank's "
                    "card, against their plain versions",
                    "card": card,
                    "held": {f"rank{r['rank']} cuda:{r['device']}":
                             r["kernels_held"] for r in ranks}}))
    for name in _FLASH:
        row = dict(r0["kernels_timed"][name], kernel=name, card=card,
                   ms_every_rank=[r["kernels_timed"][name]["ms"]
                                  for r in ranks])
        log(json.dumps({"distributed": "kernel at the TP shape", **row}))
    log(json.dumps({"distributed": "parity", "card": card, "world": n,
                    **r0["parity"], "seconds": r0["parity_s"]}))
    log(json.dumps({"distributed": "collective flight records over the "
                    "world (rank 0's diff_ranks)", "world": n,
                    "in_sync": r0["flight"]["status"] == "ok",
                    **r0["flight"]}))
    one = r0["rungs"].get("one_card")
    for key in ("dp", "dp_mp"):
        if key not in r0["rungs"]:
            log(json.dumps({"distributed": f"gpt2_medium {key}",
                            "skipped": f"needs an even world of 2 or more "
                                       f"cards, this one has {n}"}))
            continue
        row = dict(r0["rungs"][key])
        row["peak_memory_gb_every_rank"] = [r["rungs"][key]["peak_memory_gb"]
                                            for r in ranks]
        if one is not None:
            row["one_card_tokens_per_s"] = one["tokens_per_s"]
            row["one_card_step_ms"] = one["step_ms"]
            row["scaling_efficiency"] = row["tokens_per_s"] / (
                n * one["tokens_per_s"])
        else:
            row["scaling_efficiency"] = None
            row["scaling_efficiency_note"] = "a world of one card"
        log(json.dumps(row))
    totals = {name: sum(r["launches"][name] for r in ranks)
              for name in KERNELS}
    missing = [name for name in _FLASH if totals[name] == 0]
    if missing:
        raise AssertionError(f"distributed: the ranks never launched "
                             f"{missing}")
    state["child_launches"] = totals
    _dist_desync_drill(n, card)
    log(f"distributed: {time.perf_counter() - t_phase:.1f} s")


def _dist_desync_drill(n, card):
    """With two cards or more: one short launch of the parity run's tiny
    GPT at dp N (``--dist-drill``), the last rank skipping one
    ``all_reduce`` (``collective.desync``), a ``Watchdog(timeout=
    DRILL_TIMEOUT, abort_on_hang=True)`` on every rank. The waiting
    ranks' verdicts name the last rank and the collective's sequence
    number; the launch ends with the watchdog's exit code
    (EXIT_DESYNC). With one card it logs that it did not run."""
    from paddle_tpu_torch.fault import supervisor
    from paddle_tpu_torch.observability import flight
    if n < 2:
        log(json.dumps({"distributed": "desync drill", "ran": False,
                        "why": f"a desync needs two ranks or more; this "
                               f"machine has {n} card"}))
        return
    t0 = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    logdir = os.path.join(outdir, "log")
    try:
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc_per_node", str(n), "--master",
               f"127.0.0.1:{_free_port()}", "--log_dir", logdir,
               "--abort_grace", "30", os.path.abspath(__file__),
               "--dist-drill", outdir]
        proc = subprocess.run(cmd, cwd=os.path.dirname(
            os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=DRILL_LAUNCH_TIMEOUT, env=dict(
                os.environ, PADDLE_TPU_FLIGHT_RECORD=os.path.join(
                    outdir, "flight.json")))
        logs = {}
        for r in range(n):
            with open(os.path.join(logdir, f"workerlog.{r}")) as f:
                logs[r] = f.read()
        verdicts = {r: re.findall(r"cross-rank flight diff \((\d+)/\d+ "
                                  r"rank dumps\): status=(\w+)"
                                  r"(?: rank=(\d+))?(?: seq=(\d+))?", text)
                    for r, text in logs.items()}
        dumps = flight.load_dumps(os.path.join(outdir, "flight.json"),
                                  world=n)
        skipped = [e for e in dumps.get(n - 1, {}).get("entries", ())
                   if e.get("bypassed")]
        row = {"distributed": "desync drill", "ran": True, "card": card,
               "world": n, "exit_code": proc.returncode,
               "exit": supervisor.describe_exit(proc.returncode),
               "verdicts": {r: v[-1] if v else None
                            for r, v in verdicts.items()},
               "skipped": [(e["op"], e["seq"]) for e in skipped],
               "seconds": time.perf_counter() - t0}
        log(json.dumps(row))
        want = ("desync", str(n - 1), str(skipped[0]["seq"])) \
            if len(skipped) == 1 else None
        waiting = [verdicts[r][-1][1:] if verdicts[r] else None
                   for r in range(n - 1)]
        if not (proc.returncode == supervisor.EXIT_DESYNC and want
                and all(v == want for v in waiting)):
            for r, text in logs.items():
                log(f"--- drill rank {r} (last 3000 characters)\n"
                    + text[-3000:])
            raise AssertionError(f"distributed: the desync drill {row}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def _dist_drill(outdir):
    """A rank of the desync drill (``_dist_desync_drill``): two dp steps of
    the tiny GPT, then the loss averaged over the world, which the last
    rank skips; the waiting ranks block reading it, the last rank waits
    without issuing another collective, and every rank's watchdog ends
    its process."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.watchdog import Watchdog
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    dist.init_parallel_env()
    rank, n = dist.get_rank(), dist.get_world_size()
    wd = Watchdog(timeout=DRILL_TIMEOUT, poll_interval=1.0,
                  abort_on_hang=True).start()
    _dist_fleet(fleet, {"dp_degree": n})
    model = fleet.distributed_model(GPTForCausalLM(
        GPTConfig(**DIST_TINY), device="cuda", seed=9))
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=DIST_PARITY_LR, parameters=model.named_parameters()))
    per = DIST_TINY_BATCH // n
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, DIST_TINY["vocab_size"], (DIST_TINY_BATCH,
                                     DIST_TINY["max_seq_len"]))).cuda()
    ids = ids[rank * per:(rank + 1) * per]
    want = _flash_launches(DIST_TINY["num_layers"])
    for _ in range(2):
        loss = _train_step(model, opt, ids, *want)
    if rank == n - 1:
        inject.arm("collective.desync", op="all_reduce")
    with wd:                       # work in flight from here on
        mean = loss.detach().reshape(1).clone()
        dist.all_reduce(mean)      # the last rank skips it
        mean.item()                # the others block here
        time.sleep(DRILL_LAUNCH_TIMEOUT)     # the last rank waits here
    raise AssertionError(f"rank {rank}: the watchdog did not end the drill")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler breakdowns of a "
                        "bf16 forward, engine run and training step, of a "
                        "fused and an unfused step of each fusion path, "
                        "of one step of each rung, of a BERT-base step, "
                        "of a ResNet-50 rung step, of a deployed "
                        "BERT-base's Predictor.run, of a GPT-2 345M "
                        "step of each distributed run (rank 0) and of a "
                        "Transformer-base step and decode")
    parser.add_argument("--dist-rank", metavar="OUTDIR",
                        help=argparse.SUPPRESS)     # a rank of distributed
    parser.add_argument("--dist-drill", metavar="OUTDIR",
                        help=argparse.SUPPRESS)     # a rank of the drill
    args = parser.parse_args(argv)
    if args.dist_rank:
        _dist_rank(args.dist_rank, args.profile)
        return 0
    if args.dist_drill:
        _dist_drill(args.dist_drill)
        return 0
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
    t_start = time.perf_counter()
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
            # the distributed phase's ranks: their own main path's counts
            for name, n in state.pop("child_launches", {}).items():
                launches[name] += n
    log(f"chip_smoke: the run took {time.perf_counter() - t_start:.1f} s")
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
            "model_bound_ms": k["model_bound_ms"],
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
