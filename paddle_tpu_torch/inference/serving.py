"""Continuous-batching LLM serving over paged KV caches (counterpart of
``paddle_tpu/inference/serving.py``).

Same engine as the JAX package's ``PagedEngine``: a host-side
``BlockManager`` owns the physical-block free list, admission and
eviction are plain Python between ticks, and each tick runs

* chunked prefill of the slots still prefilling: a prefix is left-padded
  to a multiple of ``block_size`` and fed one ``block_size`` chunk per
  program (padded positions sit at negative sequence positions, whose
  cache writes are dropped and whose queries see nothing). Under a
  phase-split scheduler (``serving.Scheduler``) the chunks are budgeted
  per tick and the rest deferred; then
* one (max_batch, 1) decode step for every fully prefilled slot, or with
  ``speculate=`` a verify step: [last token, k draft tokens] in one
  (max_batch, k+1) forward and the accept-prefix rule, up to k+1 tokens
  a slot a tick.

Positions are per slot: RoPE offsets for LLaMA (``_LlamaArch``, GQA
through its kv heads), learned-position gathers for GPT (``_GPTArch``).
Idle lanes run with seq_len 1 and an all-zero block table, so their
writes land in block 0, the reserved trash block; mid-prefill or
memory-stalled lanes run with seq_len 0, which writes nothing.

K/V pages are stored in the model's floating dtype, or with
``kv_dtype="int8"`` as int8 pages with fp32 per-(position, head) scales.

Sampling is per request and deterministic: a sampled token's uniforms
are a counter-based hash of (engine seed, request id, tokens generated
so far, vocabulary index) (``_request_uniforms``), so a request
preempted and re-prefilled resumes the same sampled continuation, on the
CPU and on the card alike. The JAX engine folds the same three numbers
into a ``jax.random`` key; the two packages' draws differ.

The JAX engine donates its cache arrays to a jitted program each tick;
here the caches are per-layer tensors that paged attention updates in
place. The whole forward runs under ``torch.inference_mode()``.

Resilience contract (``inference/resilience.py``): the tick loop never
raises: overload, deadline expiry, memory races and injected faults
become per-request terminal statuses
(``FINISHED/SHED/DEADLINE_MISSED/CANCELLED/FAILED``) recorded in
``engine.outcomes``, with per-token timestamps; submitters see
:class:`Overloaded` backpressure from the bounded queue; the replica
walks an explicit lifecycle (``STARTING→WARMING→READY→DEGRADED→
DRAINING→STOPPED``) with ``drain()`` and health/readiness probes, and a
stalled tick flips it DEGRADED through an attached watchdog.
``engine.stream(rid)`` yields a request's tokens as they come. Every
request's lifecycle is stamped into the request flight recorder
(``observability/reqtrace.py``) from the engine's clock seam
(``engine._clock``; ``phase_seconds`` stays on the host's clock). The
multi-replica front door is ``serving.Router``.

A tick's results reach the host in a device-to-host copy of the chosen
ids, which waits for the program; token timestamps are taken after it,
so TTFT includes the card's time.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.place import DeviceLike, resolve_device
from ..fault import inject as _inject
from ..nn.functional.paged_attention import block_multihead_attention
from ..observability import reqtrace as _reqtrace
from ..observability import trace as _otrace
from ..ops.cuda.serving import spec_accept_prefix
from ..ops.search import nucleus_sample_ids
from ..serving import speculative as _spec_mod
from ..serving.scheduler import Scheduler, SchedulerConfig
from ..serving.speculative import NgramProposer
from ..serving.stream import TokenStream
from . import resilience as _res
from .resilience import (Overloaded, ReplicaLifecycle, ReplicaState,
                         RequestOutcome, RequestStatus, ResilienceConfig,
                         TERMINAL_STATUSES)

__all__ = ["BlockManager", "Request", "PagedEngine", "LlamaPagedEngine",
           "GPTPagedEngine", "Overloaded", "RequestStatus", "ReplicaState",
           "ResilienceConfig", "RequestOutcome"]

_log = logging.getLogger(__name__)


class BlockManager:
    """Physical-block free list (block 0 is the reserved trash block idle
    slots write into)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is reserved)")
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV cache exhausted: need {n} blocks, "
                f"{len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def release(self, blocks: List[int]):
        self._free.extend(b for b in blocks if b != 0)


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    top_p: float = 1.0
    generated: List[int] = field(default_factory=list)
    # --- resilience bookkeeping (engine-managed) ---
    status: str = RequestStatus.QUEUED
    detail: str = ""                  # terminal reason for non-FINISHED
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    ttft_deadline_s: Optional[float] = None   # submit -> first token
    deadline_s: Optional[float] = None        # submit -> completion

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + len(self.generated)


class _LlamaArch:
    """Architecture adapter: per-chunk forward for LlamaForCausalLM (RoPE
    at per-slot offsets, GQA, no position table)."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.num_kv_heads = model.cfg.num_kv_heads or model.cfg.num_heads

    def forward_chunk(self, tokens, start, attend, logits_t: int = 1):
        from ..models.llama import rotary_embedding

        model = self.model
        cfg = self.cfg
        B, T = tokens.shape
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        nkv = self.num_kv_heads
        x = model.model.embed_tokens(tokens)
        for li, blk in enumerate(model.model.layers):
            ln = blk.input_layernorm(x)
            att = blk.self_attn
            q = att.q_proj(ln).reshape(B, T, nh, hd)
            k = att.k_proj(ln).reshape(B, T, nkv, hd)
            v = att.v_proj(ln).reshape(B, T, nkv, hd)
            q = rotary_embedding(q, cfg.rope_theta, pos_offset=start)
            k = rotary_embedding(k, cfg.rope_theta, pos_offset=start)
            out = attend(li, q, k, v)
            x = x + att.o_proj(out.reshape(B, T, nh * hd))
            x = x + blk.mlp(blk.post_attention_layernorm(x))
        x = model.model.norm(x)
        # the head of the last logits_t positions (the embedding if tied)
        return model._head(x[:, -logits_t:, :])


class _GPTArch:
    """Architecture adapter for GPTForCausalLM (learned positions, fused
    qkv, tied head)."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.num_kv_heads = model.cfg.num_heads
        self.max_positions = model.cfg.max_seq_len

    def forward_chunk(self, tokens, start, attend, logits_t: int = 1):
        m = self.model.gpt
        B, T = tokens.shape
        h = self.cfg.hidden_size
        nh = self.cfg.num_heads
        hd = h // nh
        # learned positions at per-slot offsets; a left-padded first chunk
        # starts below 0 (those rows are masked, but an index must be valid)
        pos = (start[:, None] + torch.arange(T, device=tokens.device))
        pos = pos.clamp(0, self.max_positions - 1)
        x = m.wte(tokens) + m.wpe(pos)
        for li, blk in enumerate(m.blocks):
            q, k, v = blk.attn.qkv_proj(blk.ln1(x)).split(h, dim=-1)
            out = attend(li, q.reshape(B, T, nh, hd), k.reshape(B, T, nh, hd),
                         v.reshape(B, T, nh, hd))
            x = x + blk.attn.out_proj(out.reshape(B, T, h))
            x = x + blk.mlp(blk.ln2(x))
        x = m.ln_f(x)
        return torch.matmul(x[:, -logits_t:, :], m.wte.weight.t())


def _pick_arch(model):
    from ..models.gpt import GPTForCausalLM
    from ..models.llama import LlamaForCausalLM
    if isinstance(model, LlamaForCausalLM):
        return _LlamaArch(model)
    if isinstance(model, GPTForCausalLM):
        return _GPTArch(model)
    raise TypeError(f"PagedEngine supports LlamaForCausalLM / "
                    f"GPTForCausalLM (or subclasses); got "
                    f"{type(model).__name__}")


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply) of int64 values below
    2^32; the multiplier is below 2^31, so every product stays below
    2^63 and the arithmetic is exact on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _request_uniforms(seed: int, rids: torch.Tensor, ngens: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """(B, vocab) fp32 uniforms in [2^-24, 1 - 2^-24], odd multiples of
    2^-24, so inside the sampler's [1e-20, 1). A counter-based draw:
    element (b, j) hashes (seed, rids[b], ngens[b], j) and nothing else,
    so a request's draws depend only on its identity and how many tokens
    it has generated, never on the tick, slot or batch (the property of
    the JAX engine's ``_request_keys``). No generator state; one call for
    the whole batch; the same numbers on the CPU and on the card."""
    key = _mix32(torch.full_like(rids, int(seed) & _M32, dtype=torch.int64))
    key = _mix32(key ^ (rids.to(torch.int64) & _M32))
    key = _mix32(key ^ (ngens.to(torch.int64) & _M32))
    idx = torch.arange(vocab, device=rids.device, dtype=torch.int64)
    x = _mix32(key[:, None] ^ _mix32(idx + 0x5BD1E995)[None, :])
    return ((x >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def _sample_tokens(logits, temps, top_ps, seed, rids, ngens,
                   sampling: bool):
    """Per-slot greedy / temperature / nucleus sampling of logits (B, V).
    With ``sampling`` False (every slot greedy) only the argmax runs: no
    softmax, sort or draw. Temperatures are clamped to 1e-6 and each slot
    takes its sample where its temperature is above 0, else its argmax."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampling:
        return greedy
    safe_t = temps.clamp_min(1e-6)[:, None]
    # logits / fp32 temperatures: fp32 probabilities on a bf16 model too,
    # as the JAX promotion gives
    probs = torch.softmax(logits / safe_t, dim=-1)
    u = _request_uniforms(seed, rids, ngens, logits.shape[-1])
    sampled = nucleus_sample_ids(probs, top_ps, u)[:, 0]
    return torch.where(temps > 0, sampled, greedy)


def _make_attend(kcs, vcs, tables, seq_lens):
    """Paged-attention closure over one chunk's caches. A cache entry is
    a tensor (float pages) or a (payload, scales) pair (int8 pages); both
    are updated in place."""

    def attend(li, q, k, v):
        kc, vc, scales = kcs[li], vcs[li], {}
        if isinstance(kc, tuple):
            (kc, scales["k_scale"]), (vc, scales["v_scale"]) = kc, vc
        return block_multihead_attention(
            q, kc, vc, tables, seq_lens, new_k=k, new_v=v, causal=True,
            **scales)[0]

    return attend


def _paged_forward(arch, kcs, vcs, tokens, seq_lens, tables, temps, top_ps,
                   rids, ngens, seed, sampling: bool):
    """One chunk for a (B, T) token batch: appends the chunk's K/V to the
    caches (in place) and returns each row's next token (B,)."""
    T = tokens.shape[1]
    attend = _make_attend(kcs, vcs, tables, seq_lens)
    logits = arch.forward_chunk(tokens, seq_lens - T, attend)
    return _sample_tokens(logits[:, -1, :], temps, top_ps, seed, rids,
                          ngens, sampling)


def _paged_verify(arch, kcs, vcs, tokens, seq_lens, tables, temps, top_ps,
                  rids, ngens, seed, max_accept, sampling: bool):
    """Speculative verify: one (B, k+1) forward over [last token, k draft
    tokens] per slot and greedy accept-prefix. Returns (emit (B, k+1)
    candidate tokens, n_emit (B,) how many of them are real). Sampling
    slots ride it with ``max_accept`` 0: their position-0 logits sample
    as a decode step would (the same uniforms), drafts ignored."""
    T = tokens.shape[1]
    attend = _make_attend(kcs, vcs, tables, seq_lens)
    lg = arch.forward_chunk(tokens, seq_lens - T, attend, logits_t=T)
    greedy = torch.argmax(lg, dim=-1)                          # (B, T)
    first = _sample_tokens(lg[:, 0, :], temps, top_ps, seed, rids, ngens,
                           sampling)
    emit = torch.cat([torch.where(temps > 0, first, greedy[:, 0])[:, None],
                      greedy[:, 1:]], dim=1)
    n_emit, _ = spec_accept_prefix(tokens[:, 1:], greedy, max_accept)
    return emit, n_emit


class PagedEngine:
    """Continuous-batching engine for causal LMs over paged KV caches.

    Runs on ``device`` (default the card; ``device="cpu"`` asks for the
    CPU), which must be where the model's parameters live.

    ``seed`` keys the sampled requests' draws; ``kv_dtype`` is None (the
    model's floating dtype), a float dtype, or ``"int8"``/``torch.int8``;
    ``scheduler`` a ``SchedulerConfig`` or ``Scheduler`` (None: no
    prefill budget); ``speculate`` ``"ngram"`` (an ``NgramProposer`` of
    ``speculate_k`` tokens) or a proposer object; ``resilience`` a
    ``ResilienceConfig`` (queue bound, shedding, default deadlines, SLO
    windows)."""

    def __init__(self, model, *, max_batch: int = 8, block_size: int = 16,
                 num_blocks: int = 256, max_blocks_per_seq: int = 32,
                 eos_id: Optional[int] = None, seed: int = 0,
                 kv_dtype=None, scheduler=None, speculate=None,
                 speculate_k: int = 4,
                 resilience: Optional[ResilienceConfig] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device != self.device:
            raise ValueError(f"the model lives on {param.device}, the "
                             f"engine on {self.device}")
        self.model = model
        self.arch = _pick_arch(model)
        self.cfg = cfg = model.cfg
        self.max_batch = max_batch
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.eos_id = eos_id
        self.seed = int(seed)
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.num_kv_heads = nkv = self.arch.num_kv_heads

        if scheduler is None:
            scheduler = Scheduler()
        elif isinstance(scheduler, SchedulerConfig):
            scheduler = Scheduler(scheduler)
        self.scheduler = scheduler
        #: slot -> chunked-prefill state (padded prefix, chunk cursor); a
        #: slot decodes only once it leaves this map
        self._prefilling: Dict[int, dict] = {}

        if speculate == "ngram":
            speculate = NgramProposer(k=speculate_k)
        self._spec = speculate
        self._spec_k = getattr(speculate, "k", speculate_k)
        self.spec_proposed = 0
        self.spec_accepted = 0

        self.bm = BlockManager(num_blocks)
        self._total_usable = num_blocks - 1
        self._kv_int8 = kv_dtype == "int8" or kv_dtype is torch.int8
        if self._kv_int8:
            self.kv_dtype = torch.int8
        elif kv_dtype is None:
            self.kv_dtype = next((p.dtype for p in model.parameters()
                                  if p.dtype.is_floating_point),
                                 torch.float32)
        else:
            self.kv_dtype = convert_dtype(kv_dtype)
        self._kv_shape = (num_blocks, block_size, nkv, self.head_dim)
        self._kv_scale_shape = (num_blocks, block_size, nkv)
        self.kc = [self._fresh_cache() for _ in range(cfg.num_layers)]
        self.vc = [self._fresh_cache() for _ in range(cfg.num_layers)]
        # memory attribution: the KV pages report under the "kv_cache" tag
        # (the getter reads kc/vc anew: a reset replaces them)
        from ..observability.perf import memory as _perf_memory
        _perf_memory.register_object("kv_cache", self,
                                     lambda e: (e.kc, e.vc))

        self.tables = np.zeros((max_batch, max_blocks_per_seq), np.int32)
        self.seq_lens = np.ones((max_batch,), np.int32)  # idle: len 1
        self.last_token = np.zeros((max_batch,), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self.queue: List[Request] = []
        self.rejected: Dict[int, str] = {}
        self._done: List[Request] = []
        self._rid = 0
        self._ticks = 0
        #: preemptions so far (the JAX package counts them in a metric)
        self.evictions = 0
        #: seconds of each program, by phase (host clock around work that
        #: ends in a device-to-host copy of the chosen ids)
        self.phase_seconds: Dict[str, List[float]] = {"prefill": [],
                                                      "decode": []}
        # --- resilience state ---
        self.resilience = resilience or ResilienceConfig()
        self._clock = time.monotonic      # seam for deterministic tests
        self.lifecycle = ReplicaLifecycle(clock=self._clock)
        # SLO burn-rate accounting: every terminal outcome feeds the
        # multiwindow burn gauges of this replica's scope
        rc = self.resilience
        self._slo = _reqtrace.SloTracker(
            self.lifecycle.name, target=rc.slo_target,
            fast_window_s=rc.slo_fast_window_s,
            slow_window_s=rc.slo_slow_window_s)
        #: terminal outcome per request (drained by ``drain_outcomes``;
        #: long-running callers should drain it alongside step())
        self.outcomes: Dict[int, RequestOutcome] = {}
        self.tick_failures = 0
        #: the last contained tick failure (its traceback is logged)
        self.last_tick_failure: Optional[BaseException] = None
        self._watchdog = None
        # finished results produced while warmup() owned the step loop,
        # handed out by the next step()/run_to_completion
        self._spillover: Dict[int, List[int]] = {}
        #: per-request incremental token buffers (see stream())
        self._stream_bufs: Dict[int, List[int]] = {}
        _res.M_KV_BYTES_PER_TOKEN.set(self.kv_bytes_per_token)

    def _fresh_cache(self):
        """One layer's K (or V) page pool: a float tensor, or the int8
        (payload, scales) pair."""
        if self._kv_int8:
            return (torch.zeros(self._kv_shape, dtype=torch.int8,
                                device=self.device),
                    torch.zeros(self._kv_scale_shape, dtype=torch.float32,
                                device=self.device))
        return torch.zeros(self._kv_shape, dtype=self.kv_dtype,
                           device=self.device)

    @property
    def kv_bytes_per_token(self) -> int:
        """Resident KV bytes one cached token costs across all layers."""
        per = self.num_kv_heads * self.head_dim * self.kv_dtype.itemsize
        if self._kv_int8:
            per += self.num_kv_heads * 4          # fp32 scale
        return 2 * self.cfg.num_layers * per      # K and V

    # ------------------------------------------------- request tracing
    @property
    def reqtrace_scope(self) -> str:
        """Timeline scope this replica records under (the lifecycle's
        stable per-process replica name)."""
        return self.lifecycle.name

    def _rt_event(self, rid: int, event: str,
                  t: Optional[float] = None, **meta):
        """Stamp one lifecycle event into the request flight recorder
        (``reqtrace.emit``: the disabled path reads no clock; timestamps
        come from the engine's clock seam)."""
        _reqtrace.emit(self.lifecycle.name, self._clock, rid, event, t,
                       **meta)

    # ---------------------------------------------------------------- API
    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    temperature: float = 0.0, top_p: float = 1.0,
                    ttft_deadline_s: Optional[float] = None,
                    deadline_s: Optional[float] = None) -> int:
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("add_request: prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("add_request: max_new_tokens must be >= 1")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("add_request: top_p must be in (0, 1]")
        if not temperature >= 0.0:   # also rejects NaN
            raise ValueError("add_request: temperature must be >= 0")
        max_pos = getattr(self.arch, "max_positions", None)
        if max_pos is not None and len(prompt) + max_new_tokens > max_pos:
            # learned positions: a sequence past the table would gather
            # the last embedding
            raise ValueError(
                f"add_request: prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's position table "
                f"({max_pos})")
        # ---- admission control: backpressure is an exception the
        # submitter handles; everything after acceptance is a status ----
        if not self.lifecycle.admitting():
            raise Overloaded(
                f"replica is {self.lifecycle.state}: not accepting "
                f"requests")
        rcfg = self.resilience
        if len(self.queue) >= rcfg.max_queue:
            raise Overloaded(
                f"admission queue full ({rcfg.max_queue} queued); retry "
                f"on another replica")
        self._rid += 1
        req = Request(self._rid, prompt, max_new_tokens,
                      temperature=float(temperature), top_p=float(top_p))
        req.submit_t = self._clock()
        req.ttft_deadline_s = (ttft_deadline_s if ttft_deadline_s
                               is not None
                               else rcfg.default_ttft_deadline_s)
        req.deadline_s = (deadline_s if deadline_s is not None
                          else rcfg.default_deadline_s)
        self._rt_event(req.rid, "submitted", t=req.submit_t,
                       prompt_tokens=len(prompt),
                       max_new_tokens=max_new_tokens,
                       ttft_deadline_s=req.ttft_deadline_s,
                       deadline_s=req.deadline_s)
        need_total = self._blocks_needed(len(prompt) + max_new_tokens)
        if (need_total > self.max_blocks_per_seq
                or need_total > self._total_usable):
            # can never fit this replica's geometry: terminal FAILED at
            # submit time
            reason = (f"needs {need_total} blocks (max_blocks_per_seq="
                      f"{self.max_blocks_per_seq}, usable="
                      f"{self._total_usable})")
            self.rejected[req.rid] = reason
            self._finish_request(req, RequestStatus.FAILED, detail=reason)
            return req.rid
        self.queue.append(req)
        _res.M_QUEUE_DEPTH.set(len(self.queue))
        return req.rid

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return bool(self.queue) or self.num_active > 0

    # ----------------------------------------------------------- compute
    def _tensors(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _launch(self, program, phase, tokens_np, seq_lens_np, sampling_np,
                extra=()):
        """Run ``program`` (``_paged_forward`` or ``_paged_verify``) over
        the batch, in eval mode under inference mode, and copy its results
        to the host; books its seconds and scheduled tokens under
        ``phase``, and a ``serving.<phase>`` span (category ``device``)
        when the span buffer is active. The copy waits for the program,
        so the seconds and the span cover the host's launches and the
        card's time together. ``sampling_np`` is (temps, top_ps, rids,
        ngens)."""
        was_training = self.model.training
        if was_training:
            self.model.eval()
        sampling = bool(np.any(sampling_np[0] > 0))
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                tok, sl, tb = self._tensors(tokens_np.astype(np.int64),
                                            seq_lens_np.astype(np.int64),
                                            self.tables.astype(np.int64))
                out = program(self.arch, self.kc, self.vc, tok, sl, tb,
                              *self._tensors(*sampling_np), self.seed,
                              *self._tensors(*extra), sampling=sampling)
                out = [o.cpu().numpy() for o in
                       (out if isinstance(out, tuple) else (out,))]
        finally:
            if was_training:
                self.model.train()
        t1 = time.perf_counter()
        self.phase_seconds[phase].append(t1 - t0)
        self.scheduler.note_phase(phase, tokens_np.size, t1 - t0)
        if _otrace._active["on"]:
            args = {"phase": phase, "batch": int(len(seq_lens_np))}
            if program is _paged_verify:
                args["speculative"] = True
            _otrace.add_complete(f"serving.{phase}", "device", t0, t1,
                                 args)
        return out

    def _run_chunk(self, tokens_np, seq_lens_np, sampling_np,
                   phase: str) -> np.ndarray:
        return self._launch(_paged_forward, phase, tokens_np, seq_lens_np,
                            sampling_np)[0]

    def _run_verify(self, tokens_np, seq_lens_np, sampling_np,
                    max_accept_np):
        """The verify program: decode-phase compute (it is the decode
        step, yielding up to k+1 tokens)."""
        return self._launch(_paged_verify, "decode", tokens_np, seq_lens_np,
                            sampling_np, (max_accept_np,))

    def _slot_sampling(self, slots):
        """(temps, top_ps, rids, ngens) of the batch: each slot in
        ``slots`` its request's, every other lane greedy."""
        temps = np.zeros((self.max_batch,), np.float32)
        top_ps = np.ones((self.max_batch,), np.float32)
        rids = np.zeros((self.max_batch,), np.int64)
        ngens = np.zeros((self.max_batch,), np.int64)
        for i in slots:
            req = self.slots[i]
            temps[i] = req.temperature
            top_ps[i] = req.top_p
            rids[i] = req.rid
            ngens[i] = len(req.generated)
        return temps, top_ps, rids, ngens

    # -------------------------------------------------------- scheduling
    def _blocks_needed(self, length: int) -> int:
        return -(-length // self.block_size)

    def _ensure_blocks(self, slot: int, length: int) -> bool:
        need = self._blocks_needed(length)
        have = len(self.slot_blocks[slot])
        if need > self.max_blocks_per_seq:
            raise MemoryError(
                f"sequence needs {need} blocks > max_blocks_per_seq "
                f"{self.max_blocks_per_seq}")
        if need > have:
            if need - have > self.bm.available:
                return False
            new = self.bm.allocate(need - have)
            for j, b in enumerate(new):
                self.tables[slot, have + j] = b
            self.slot_blocks[slot].extend(new)
        return True

    def _admit(self):
        for slot in range(self.max_batch):
            if not self.queue or self.slots[slot] is not None:
                continue
            req = self.queue[0]
            prefix_len = req.seq_len
            if self._blocks_needed(prefix_len + 1) > self.bm.available:
                break  # head-of-line blocks until memory frees
            self.queue.pop(0)
            self.slots[slot] = req
            self.tables[slot, :] = 0
            self.slot_blocks[slot] = []
            # allocate the prefix blocks now, so the next admission's
            # availability check sees the reduced pool
            raced = _inject.fire("serving.admission_oom") is not None
            if raced or not self._ensure_blocks(slot, prefix_len):
                # admission raced cache exhaustion (another slot's growth
                # won the last blocks): un-admit and retry next tick
                self._release_slot(slot)
                self.queue.insert(0, req)
                break
            req.status = RequestStatus.RUNNING
            _res.M_ADMITTED.inc()
            self._rt_event(req.rid, "admitted", slot=slot,
                           prefix_tokens=prefix_len,
                           tick=self._ticks,
                           kv_blocks=len(self.slot_blocks[slot]))
            # stage the chunked prefill, left-padded to whole chunks
            bs = self.block_size
            prefix = np.asarray(req.prompt + req.generated, np.int32)
            n_chunks = -(-len(prefix) // bs)
            pad = n_chunks * bs - len(prefix)
            self._prefilling[slot] = {
                "prefix": np.concatenate([np.zeros(pad, np.int32), prefix]),
                "n_chunks": n_chunks, "next": 0, "pad": pad}

    def _prefill_step(self):
        """Advance pending chunked prefills under the scheduler's budget:
        each program carries the next chunk of up to ``quota`` prefilling
        slots (slots at different chunk indices share one program;
        per-slot seq_lens place the writes). A slot's final chunk yields
        its first token; chunks past the budget wait for a later tick."""
        bs = self.block_size
        quota = self.scheduler.chunk_quota(bs)
        while self._prefilling:
            slots = sorted(self._prefilling)
            if quota is not None:
                slots = slots[:quota]
                if not slots:
                    self.scheduler.note_deferred(sum(
                        st["n_chunks"] - st["next"]
                        for st in self._prefilling.values()))
                    # the why of a slow TTFT: this tick's budget pushed
                    # these requests' remaining chunks to a later tick
                    for slot, st in self._prefilling.items():
                        req = self.slots[slot]
                        if req is not None:
                            self._rt_event(
                                req.rid, "prefill_deferred",
                                tick=self._ticks,
                                chunks_left=st["n_chunks"] - st["next"])
                    return
            tokens = np.zeros((self.max_batch, bs), np.int32)
            seq = np.zeros((self.max_batch,), np.int32)   # 0 = inactive
            finalists = []
            for slot in slots:
                st = self._prefilling[slot]
                j = st["next"]
                tokens[slot] = st["prefix"][j * bs:(j + 1) * bs]
                seq[slot] = (j + 1) * bs - st["pad"]
                st["next"] = j + 1
                if st["next"] == st["n_chunks"]:
                    finalists.append(slot)
            nxt = self._run_chunk(tokens, seq, self._slot_sampling(slots),
                                  phase="prefill")
            if quota is not None:
                quota -= len(slots)
            now = self._clock()
            for slot in slots:
                # the chunk just computed is the one before the cursor
                st = self._prefilling[slot]
                req = self.slots[slot]
                self._rt_event(req.rid, "prefill_chunk", t=now,
                               chunk=st["next"] - 1,
                               n_chunks=st["n_chunks"], tokens=bs,
                               tick=self._ticks)
            for slot in finalists:
                del self._prefilling[slot]
                req = self.slots[slot]
                # cached positions == the prefilled prefix; the sampled
                # token lands in the cache on its decode step
                self.seq_lens[slot] = req.seq_len
                tok = int(nxt[slot])
                req.generated.append(tok)
                self.last_token[slot] = tok
                self._record_token(req, now)
                self._maybe_finish(slot)

    def _evict(self, slot: int,
               reason: str = "kv-block pressure (livelock preemption)"):
        """Preempt a running request: release its blocks and requeue it
        (its generated prefix re-prefills at re-admission)."""
        req = self.slots[slot]
        freed = len(self.slot_blocks[slot])
        self._release_slot(slot)
        req.status = RequestStatus.QUEUED
        self.evictions += 1
        _res.M_EVICTIONS.inc()
        self._rt_event(req.rid, "preempted", victim_reason=reason,
                       tick=self._ticks, kv_blocks_reclaimed=freed,
                       tokens_so_far=len(req.generated))
        self.queue.append(req)

    def _release_slot(self, slot: int):
        """Return a slot's KV blocks to the free list and reset its lane
        (idle lanes point at the trash block)."""
        self.slots[slot] = None
        self._prefilling.pop(slot, None)
        self.bm.release(self.slot_blocks[slot])
        self.slot_blocks[slot] = []
        self.tables[slot, :] = 0
        self.seq_lens[slot] = 1
        self.last_token[slot] = 0

    def _finish_request(self, req: Request, status: str,
                        detail: str = ""):
        """Move ``req`` to a terminal status and record its outcome. The
        caller must already have released any slot/blocks it held."""
        req.status = status
        req.detail = detail
        req.finish_t = self._clock()
        self._rt_event(req.rid, "terminal", t=req.finish_t,
                       outcome=status, detail=detail,
                       tokens=len(req.generated))
        self._slo.note(req.finish_t,
                       good=(status == RequestStatus.FINISHED))
        _res.M_REQUESTS.inc(outcome=status)
        if status == RequestStatus.SHED:
            _res.M_SHED.inc()
        elif status == RequestStatus.DEADLINE_MISSED:
            _res.M_DEADLINE_MISSED.inc()
        self.outcomes[req.rid] = RequestOutcome(
            rid=req.rid, status=status, detail=detail,
            tokens=list(req.generated), submit_t=req.submit_t,
            first_token_t=req.first_token_t, finish_t=req.finish_t,
            token_times=list(req.token_times))
        self._stream_bufs.pop(req.rid, None)
        if status == RequestStatus.FINISHED:
            self._done.append(req)

    def _record_token(self, req: Request, now: float):
        """TTFT / inter-token latency bookkeeping for one new token; the
        worst TTFT/ITL samples keep their request id (exemplars), so a
        p99 regression resolves to a timeline."""
        traced = _reqtrace.enabled()
        if req.first_token_t is None:
            req.first_token_t = now
            if req.submit_t is not None:
                ttft = now - req.submit_t
                _res.M_TTFT.observe(ttft)
                if traced:
                    self._rt_event(req.rid, "first_token", t=now,
                                   ttft_s=ttft)
                    _reqtrace.EXEMPLARS.note(
                        "ttft", self.lifecycle.name, req.rid, ttft, now)
        elif req.token_times:
            itl = now - req.token_times[-1]
            _res.M_ITL.observe(itl)
            if traced:
                _reqtrace.EXEMPLARS.note(
                    "itl", self.lifecycle.name, req.rid, itl, now)
        req.token_times.append(now)
        buf = self._stream_bufs.get(req.rid)
        if buf is not None:
            buf.append(req.generated[-1])

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        last = req.generated[-1] if req.generated else None
        if (len(req.generated) >= req.max_new_tokens
                or (self.eos_id is not None and last == self.eos_id)):
            self._release_slot(slot)
            self._finish_request(req, RequestStatus.FINISHED)

    # ------------------------------------------------- deadlines/overload
    def _deadline_expired(self, req: Request, now: float) -> Optional[str]:
        """Reason string when ``req`` is past a deadline, else None."""
        if req.submit_t is None:
            return None
        waited = now - req.submit_t
        if req.deadline_s is not None and waited > req.deadline_s:
            return (f"total deadline {req.deadline_s}s expired after "
                    f"{waited:.3f}s ({len(req.generated)} tokens)")
        if (req.first_token_t is None and req.ttft_deadline_s is not None
                and waited > req.ttft_deadline_s):
            return (f"TTFT deadline {req.ttft_deadline_s}s expired after "
                    f"{waited:.3f}s with no first token")
        return None

    def _expire_deadlines(self):
        """Cancel queued and in-flight requests whose TTFT/total deadline
        has passed; in-flight cancellations reclaim their KV blocks."""
        now = self._clock()
        kept = []
        for req in self.queue:
            why = self._deadline_expired(req, now)
            if why is None:
                kept.append(req)
            else:
                self._finish_request(req, RequestStatus.DEADLINE_MISSED,
                                     detail=why)
        self.queue = kept
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            why = self._deadline_expired(req, now)
            if why is not None:
                self._release_slot(slot)
                self._finish_request(req, RequestStatus.DEADLINE_MISSED,
                                     detail=why)

    def _shed_overload(self):
        """Past the queue high-water mark, shed the newest queued
        requests (they would wait longest) down to the mark. Preempted
        requests carrying generated tokens are spared: shedding them
        would discard paid-for compute (the queue stays bounded by
        max_queue regardless)."""
        hw = self.resilience.queue_high_water
        if hw is None or len(self.queue) <= hw:
            return
        excess = len(self.queue) - hw
        kept_rev: List[Request] = []
        for req in reversed(self.queue):          # newest first
            if excess > 0 and not req.generated:
                excess -= 1
                self._finish_request(
                    req, RequestStatus.SHED,
                    detail=f"queue past high-water mark ({hw})")
            else:
                kept_rev.append(req)
        self.queue = kept_rev[::-1]

    def _eviction_key(self, slot: int):
        """Preemption victim ordering: most deadline slack first (no
        deadline = infinite slack), youngest rid as tie-break: evicting
        the request closest to its deadline would turn one preemption
        into a deadline miss."""
        req = self.slots[slot]
        if req.deadline_s is not None and req.submit_t is not None:
            dl = req.submit_t + req.deadline_s
        else:
            dl = float("inf")
        return (dl, req.rid)

    # ------------------------------------------------------------- ticks
    def step(self) -> Dict[int, List[int]]:
        """One engine tick: expire deadlines, admit queued requests,
        shed overload, advance chunked prefill under the scheduler's
        budget, then one batched decode (or speculative verify) step for
        every fully prefilled slot. Returns {rid: generated_tokens} for
        requests that finished this tick.

        Never raises from scheduling, memory pressure, or injected
        faults: a tick failure marks the in-flight requests FAILED,
        reclaims their KV blocks, reallocates the pages and flips the
        replica DEGRADED; the engine keeps serving. Only an error in
        that containment itself (a sticky CUDA error makes the page
        allocation raise) leaves the tick."""
        wd = self._watchdog
        if wd is not None:
            wd.begin_work()
        self._ticks += 1
        t0 = time.perf_counter()
        span_args = {"tick": self._ticks}
        try:
            with _otrace.span("serving.tick", "serving", args=span_args):
                try:
                    self._tick()
                    if self.lifecycle.state == ReplicaState.STARTING:
                        self.lifecycle.to(ReplicaState.READY, "serving")
                except Exception as e:
                    self._on_tick_failure(e)
                finally:
                    # this tick's phase split rides its span (read at
                    # span exit, before end_tick resets it)
                    span_args.update(
                        self.scheduler.tick_phase_seconds())
        finally:
            if wd is not None:
                wd.end_work()
            self.scheduler.end_tick()
            _res.M_TICK_SECONDS.observe(time.perf_counter() - t0)
            _res.M_QUEUE_DEPTH.set(len(self.queue))
            _res.M_KV_BLOCKS.set(self._total_usable - self.bm.available)
        return self._drain_done()

    def _tick(self):
        stall = _inject.fire("serving.tick_stall")
        if stall is not None:
            # a wedged device transfer: the tick thread blocks and no
            # progress reaches the watchdog
            time.sleep(float(stall.get("seconds", 0.1)))
        if _inject.fire("serving.crash_at_tick",
                        tick=self._ticks) is not None:
            raise _inject.InjectedFault(
                "serving.crash_at_tick",
                f"injected crash at tick {self._ticks}")
        self._expire_deadlines()
        # admit before shedding: a burst hitting an idle replica flows
        # into free decode slots first; only what capacity could not
        # absorb this tick counts against the high-water mark
        self._admit()
        self._shed_overload()
        # phase split: bounded prefill, then decode, which runs every
        # tick there is decodable work
        self._prefill_step()
        self._decode_active()

    def _decode_active(self):
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._prefilling]
        if not active:
            return
        if self._spec is not None and self._spec_feasible(active):
            self._decode_speculative(active)
            return
        self._decode_plain(active)

    def _spec_feasible(self, active: List[int]) -> bool:
        """Speculate this tick only when every active slot has table room
        for the k draft positions: a verify that ran past a slot's
        ``max_blocks_per_seq`` would write outside its pages. Such ticks
        take plain decode, which admission guarantees always fits."""
        cap = self.max_blocks_per_seq * self.block_size
        return all(self.slots[i].seq_len + self._spec_k <= cap
                   for i in active)

    def _decode_plain(self, active: List[int]):
        seq = self.seq_lens.copy()
        for i in self._prefilling:
            seq[i] = 0               # masked lane: no write, no attend
        skipped = []
        for i in active:
            # the cache holds seq_len-1 positions; the token being fed
            # lands at position seq_len-1
            seq[i] = self.slots[i].seq_len
            if not self._ensure_blocks(i, int(seq[i])):
                # out of blocks: skip this slot's tick. seq=0, not 1: with
                # 1 the write would land on position 0 of the slot's first
                # real block and corrupt the cached prompt
                seq[i] = 0
                skipped.append(i)
        if skipped and len(skipped) == len(active):
            # every active slot is stalled on memory: nobody can finish
            # to free blocks. Preempt the slot with the most deadline
            # slack and retry next tick with its blocks free.
            self._evict(max(skipped, key=self._eviction_key))
            return
        tokens = self.last_token[:, None].astype(np.int32)
        nxt = self._run_chunk(tokens, seq, self._slot_sampling(active),
                              phase="decode")
        now = self._clock()
        for i in active:
            if seq[i] == 0:
                continue
            req = self.slots[i]
            req.generated.append(int(nxt[i]))
            self.seq_lens[i] = int(seq[i])   # cached positions now
            self.last_token[i] = int(nxt[i])
            self._rt_event(req.rid, "decode_tick", t=now,
                           tick=self._ticks, new_tokens=1)
            self._record_token(req, now)
            self._maybe_finish(i)

    def _decode_speculative(self, active: List[int]):
        """Decode through the verify program: per active slot, feed [last
        token, k n-gram draft tokens] in one (B, k+1) forward and take the
        accepted prefix and the model's own next token. Greedy output is
        the plain decode's: a draft token is kept only where the model
        would have emitted it itself.

        The verify writes K/V at every draft position, and the slot's
        cached length then rolls back to ``req.seq_len - 1``: positions
        below it hold the fed tokens that were accepted, and a rejected
        draft's position lies at or past it, so the next program writes
        it before any query can read it (a query reads only positions at
        or before its own, and each program writes its own positions
        first)."""
        k = self._spec_k
        T = k + 1
        seq = self.seq_lens.copy()
        for i in range(self.max_batch):
            if i not in active:
                seq[i] = 0           # idle / mid-prefill: masked lane
        tokens = np.zeros((self.max_batch, T), np.int32)
        max_accept = np.zeros((self.max_batch,), np.int64)
        skipped = []
        max_pos = getattr(self.arch, "max_positions", None)
        for i in active:
            req = self.slots[i]
            # the draft positions reach seq_len-1+k: allocate for the
            # whole verify up front
            if not self._ensure_blocks(i, req.seq_len + k):
                seq[i] = 0
                skipped.append(i)
                continue
            draft: List[int] = []
            if req.temperature == 0:
                draft = list(self._spec.propose(
                    req.prompt + req.generated))[:k]
            ma = len(draft)
            if max_pos is not None:
                # drafts past a learned-position table cannot be verified
                ma = max(0, min(ma, max_pos - req.seq_len))
            row = [int(self.last_token[i])] + draft
            row += [row[-1]] * (T - len(row))     # pad: never accepted
            tokens[i] = row
            seq[i] = req.seq_len + k
            max_accept[i] = ma
        if skipped and len(skipped) == len(active):
            self._evict(max(skipped, key=self._eviction_key))
            return
        if not skipped and not max_accept.any():
            # nothing speculates this tick (a sampling-only batch, or the
            # proposer came up dry): the plain (B, 1) decode emits the
            # same tokens for less work
            self._decode_plain(active)
            return
        ready = [i for i in active if i not in skipped]
        emit, n_emit = self._run_verify(tokens, seq,
                                        self._slot_sampling(ready),
                                        max_accept)
        now = self._clock()
        proposed = accepted = 0
        for i in ready:
            req = self.slots[i]
            ne = int(n_emit[i])
            proposed += int(max_accept[i])
            accepted += ne - 1
            self._rt_event(req.rid, "spec_verify", t=now,
                           tick=self._ticks,
                           proposed=int(max_accept[i]),
                           accepted=ne - 1, new_tokens=ne)
            for j in range(ne):
                tok = int(emit[i, j])
                req.generated.append(tok)
                self.last_token[i] = tok
                self._record_token(req, now)
                if (len(req.generated) >= req.max_new_tokens
                        or (self.eos_id is not None and tok == self.eos_id)):
                    break            # _maybe_finish releases the slot
            # cached positions: all but the newest token, as after decode
            self.seq_lens[i] = req.seq_len - 1
            self._maybe_finish(i)
        if proposed:
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            _spec_mod.M_SPEC_PROPOSED.inc(proposed)
            _spec_mod.M_SPEC_ACCEPTED.inc(accepted)
            _spec_mod.M_SPEC_ACCEPT_RATE.set(
                self.spec_accepted / max(self.spec_proposed, 1))

    def _on_tick_failure(self, exc: BaseException):
        """Contain an unexpected tick error: the in-flight requests are
        FAILED (their KV state is suspect), their blocks reclaimed, the
        pages reallocated, and the replica degrades: it keeps serving new
        requests, but the readiness probe goes red so a balancer backs
        off. The traceback is logged; the exception is kept in
        ``last_tick_failure``."""
        _res.M_TICK_FAILURES.inc()
        self.tick_failures += 1
        detail = f"tick {self._ticks} failed: {exc!r}"
        _log.error("%s; in-flight requests FAILED", detail, exc_info=exc)
        self.last_tick_failure = exc
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            try:
                self._release_slot(slot)
            except Exception:
                self.slots[slot] = None   # never mask the containment
            self._finish_request(req, RequestStatus.FAILED, detail=detail)
        # the pages were written in place, and a program that failed part
        # way left partial writes in them: reallocate, as the JAX engine
        # does for its donated buffers. Every slot was discarded above, so
        # later admissions re-prefill from their prompts. The old pools go
        # first (the traceback's frames hold them too), so the peak does
        # not double the KV memory.
        exc.__traceback__ = None
        self.kc = self.vc = []
        self.kc = [self._fresh_cache() for _ in range(self.cfg.num_layers)]
        self.vc = [self._fresh_cache() for _ in range(self.cfg.num_layers)]
        self.lifecycle.degrade(detail)

    def _drain_done(self) -> Dict[int, List[int]]:
        """Hand completed requests to the caller and drop them: a
        long-running server must not retain every request ever served."""
        out = dict(self._spillover)   # client traffic served mid-warmup
        self._spillover.clear()
        out.update((req.rid, req.generated) for req in self._done)
        self._done.clear()
        return out

    def run_to_completion(self, max_ticks: int = 10_000
                          ) -> Dict[int, List[int]]:
        """Tick until no work remains; returns {rid: generated_tokens}
        for FINISHED requests. Requests that ended SHED /
        DEADLINE_MISSED / CANCELLED / FAILED are absent here: read
        ``self.outcomes`` (or ``drain_outcomes()``) for their terminal
        records; never-fitting submissions also appear in
        ``self.rejected``."""
        out: Dict[int, List[int]] = {}
        ticks = 0
        while self.has_work():
            out.update(self.step())
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("serving engine did not converge")
        return out

    # ------------------------------------------------ replica operations
    def request_status(self, rid: int) -> Optional[str]:
        """Current status of a submitted request (terminal statuses stay
        readable until ``drain_outcomes`` pops them); None = unknown."""
        oc = self.outcomes.get(rid)
        if oc is not None:
            return oc.status
        for req in self.queue:
            if req.rid == rid:
                return req.status
        for req in self.slots:
            if req is not None and req.rid == rid:
                return req.status
        return None

    def drain_outcomes(self) -> Dict[int, RequestOutcome]:
        """Hand terminal outcomes to the caller and drop them (a
        long-running replica must not retain every request ever
        served)."""
        out, self.outcomes = self.outcomes, {}
        for rid in out:          # rejected mirrors submit-time FAILED
            self.rejected.pop(rid, None)
        return out

    def cancel(self, rid: int, reason: str = "cancelled by caller") -> bool:
        """Cancel a queued or in-flight request; its KV blocks return to
        the free list immediately. False if ``rid`` is not live."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                self._finish_request(req, RequestStatus.CANCELLED,
                                     detail=reason)
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                self._release_slot(slot)
                self._finish_request(req, RequestStatus.CANCELLED,
                                     detail=reason)
                return True
        return False

    # --------------------------------------------------------- streaming
    def open_stream(self, rid: int) -> List[int]:
        """Attach (or fetch) the incremental token buffer for ``rid``;
        every token the request generates from now on is appended.
        Tokens generated before the stream opened are replayed first, so
        a late-attaching client still sees the whole completion. The
        buffer stays valid after the request ends."""
        buf = self._stream_bufs.get(rid)
        if buf is not None:
            return buf
        buf = []
        oc = self.outcomes.get(rid)
        if oc is not None:               # already terminal: replay only
            buf.extend(oc.tokens)
            return buf
        for req in list(self.queue) + [s for s in self.slots
                                       if s is not None]:
            if req.rid == rid:
                buf.extend(req.generated)
                self._stream_bufs[rid] = buf
                return buf
        return buf                       # unknown rid: empty, terminal

    def stream(self, rid: int) -> TokenStream:
        """Incremental token stream for one request: iterate tokens as
        ticks produce them (the iterator pumps ``step()`` while the
        request is live); iteration ends at the terminal status, left on
        ``stream.status``."""
        return TokenStream(
            rid, self.open_stream(rid), self.step,
            lambda: self.request_status(rid),
            lambda s: s is None or s in TERMINAL_STATUSES,
            trace_hook=lambda ev, **meta: self._rt_event(rid, ev, **meta))

    def warmup(self, prompt_len: Optional[int] = None,
               max_new_tokens: int = 2) -> "PagedEngine":
        """Run one synthetic request through prefill and decode before
        real traffic: STARTING→WARMING→READY. Idempotent on a READY
        replica.

        Traffic that arrived before READY (admission is open from
        STARTING) is served alongside the synthetic request; its results
        are handed out by the next ``step()``/``run_to_completion``."""
        if self.lifecycle.state == ReplicaState.READY:
            return self
        self.lifecycle.to(ReplicaState.WARMING, "warmup")
        n = prompt_len if prompt_len is not None else self.block_size
        rid = self.add_request([1] * max(1, n),
                               max_new_tokens=max_new_tokens)
        # the synthetic request is operator work: no SLO deadlines, and
        # it jumps to the queue head so a pre-READY client burst can
        # neither starve nor shed it
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                req.ttft_deadline_s = req.deadline_s = None
                self.queue.insert(0, self.queue.pop(i))
                break
        while self.outcomes.get(rid) is None and self.has_work():
            res = self.step()
            res.pop(rid, None)          # warmup is not traffic
            self._spillover.update(res)
        oc = self.outcomes.pop(rid, None)
        if oc is None or oc.status != RequestStatus.FINISHED:
            # stay in WARMING (still admits): READY would advertise a
            # replica that never completed a request
            raise RuntimeError(
                f"warmup request ended "
                f"{oc.status if oc else '<missing>'}: "
                f"{oc.detail if oc else ''}")
        self.lifecycle.to(ReplicaState.READY, "warmup complete")
        return self

    def drain(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        """Graceful shutdown: stop admission, finish in-flight decodes,
        then STOP. Queued requests that never got a slot are CANCELLED
        (their clients retry on another replica); running requests
        decode to completion. Returns {rid: tokens} finished during the
        drain."""
        if self.lifecycle.state == ReplicaState.STOPPED:
            return {}
        self.lifecycle.to(ReplicaState.DRAINING, "drain()")
        for req in self.queue:
            self._finish_request(req, RequestStatus.CANCELLED,
                                 detail="drained before admission")
        self.queue = []
        out: Dict[int, List[int]] = {}
        ticks = 0
        # loop on has_work(), not num_active: livelock preemption can
        # bounce an in-flight request back through the queue mid-drain,
        # and it still must reach a terminal status
        while self.has_work():
            out.update(self.step())
            ticks += 1
            if ticks > max_ticks:
                # fail whatever is still live rather than spin forever
                for req in self.queue:
                    self._finish_request(req, RequestStatus.FAILED,
                                         detail="drain did not converge")
                self.queue = []
                for slot, req in enumerate(self.slots):
                    if req is not None:
                        self._release_slot(slot)
                        self._finish_request(
                            req, RequestStatus.FAILED,
                            detail="drain did not converge")
                break
        self.lifecycle.to(ReplicaState.STOPPED, "drained")
        _res.M_QUEUE_DEPTH.set(0)
        _res.M_KV_BLOCKS.set(self._total_usable - self.bm.available)
        return out

    def recover(self, reason: str = "operator recover"):
        """DEGRADED → READY once the operator (or an orchestrator health
        check) has decided the stall/crash cause is gone."""
        self.lifecycle.to(ReplicaState.READY, reason)

    def attach_watchdog(self, watchdog) -> "PagedEngine":
        """Wire a :class:`~paddle_tpu_torch.distributed.watchdog.Watchdog`
        into the tick loop: every tick brackets begin_work/end_work (so
        an idle engine stays quiet), and a tick stalled past the
        watchdog's timeout flips this replica DEGRADED while the
        watchdog dumps thread stacks and the span buffer's tail."""
        self._watchdog = watchdog
        prev = watchdog.on_hang

        def _on_hang(wd):
            self.lifecycle.degrade(
                f"tick stalled > {wd.timeout}s (watchdog)")
            if prev is not None:
                prev(wd)

        watchdog.on_hang = _on_hang
        return self

    def health(self) -> dict:
        """Liveness/readiness probe payload (what an HTTP /healthz in
        front of this replica returns)."""
        lc = self.lifecycle
        h = {"state": lc.state, "ready": lc.ready(),
             "live": lc.live(),
             "queue_depth": len(self.queue),
             "active": self.num_active,
             "prefilling": len(self._prefilling),
             "kv_blocks_free": self.bm.available,
             "kv_blocks_total": self._total_usable,
             "kv_dtype": str(self.kv_dtype).replace("torch.", ""),
             "kv_bytes_per_token": self.kv_bytes_per_token,
             "ticks": self._ticks,
             "tick_failures": self.tick_failures,
             "phase_share": self.scheduler.phase_share(),
             # the probe doubles as the burn-rate decay poll: an idle
             # replica's windows age out here, so the gauges fall back
             # to 0 after an incident instead of pinning high
             "slo_burn_rate": self._slo.burn_rates(self._clock())}
        if self._spec is not None:
            h["spec_acceptance_rate"] = (
                self.spec_accepted / self.spec_proposed
                if self.spec_proposed else None)
        return h


# The generic engine picks the adapter itself (the JAX package's names).
LlamaPagedEngine = PagedEngine
GPTPagedEngine = PagedEngine
