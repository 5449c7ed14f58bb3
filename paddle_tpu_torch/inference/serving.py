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

The resilience layer (lifecycle, deadlines, backpressure, outcomes,
streams) and the request tracing and metrics come with a later slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.place import DeviceLike, resolve_device
from ..nn.functional.paged_attention import block_multihead_attention
from ..ops.cuda.serving import spec_accept_prefix
from ..ops.search import nucleus_sample_ids
from ..serving.scheduler import Scheduler, SchedulerConfig
from ..serving.speculative import NgramProposer
from .resilience import RequestStatus

__all__ = ["BlockManager", "Request", "PagedEngine", "LlamaPagedEngine",
           "GPTPagedEngine", "RequestStatus"]


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
    status: str = RequestStatus.QUEUED

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
    ``speculate_k`` tokens) or a proposer object."""

    def __init__(self, model, *, max_batch: int = 8, block_size: int = 16,
                 num_blocks: int = 256, max_blocks_per_seq: int = 32,
                 eos_id: Optional[int] = None, seed: int = 0,
                 kv_dtype=None, scheduler=None, speculate=None,
                 speculate_k: int = 4, device: DeviceLike = None):
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

    # ---------------------------------------------------------------- API
    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    temperature: float = 0.0, top_p: float = 1.0) -> int:
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
        self._rid += 1
        req = Request(self._rid, prompt, max_new_tokens,
                      temperature=float(temperature), top_p=float(top_p))
        need_total = self._blocks_needed(len(prompt) + max_new_tokens)
        if (need_total > self.max_blocks_per_seq
                or need_total > self._total_usable):
            reason = (f"needs {need_total} blocks (max_blocks_per_seq="
                      f"{self.max_blocks_per_seq}, usable="
                      f"{self._total_usable})")
            self.rejected[req.rid] = reason
            req.status = RequestStatus.FAILED
            return req.rid
        self.queue.append(req)
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
        ``phase``. ``sampling_np`` is (temps, top_ps, rids, ngens)."""
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
        seconds = time.perf_counter() - t0
        self.phase_seconds[phase].append(seconds)
        self.scheduler.note_phase(phase, tokens_np.size, seconds)
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
            self._ensure_blocks(slot, prefix_len)
            req.status = RequestStatus.RUNNING
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
            for slot in finalists:
                del self._prefilling[slot]
                req = self.slots[slot]
                # cached positions == the prefilled prefix; the sampled
                # token lands in the cache on its decode step
                self.seq_lens[slot] = req.seq_len
                tok = int(nxt[slot])
                req.generated.append(tok)
                self.last_token[slot] = tok
                self._maybe_finish(slot)

    def _evict(self, slot: int):
        """Preempt a running request: release its blocks and requeue it
        (its generated prefix re-prefills at re-admission)."""
        req = self.slots[slot]
        self._release_slot(slot)
        req.status = RequestStatus.QUEUED
        self.evictions += 1
        self.queue.append(req)

    def _evict_youngest(self, skipped: List[int]):
        """Every active slot is stalled on memory: preempt the youngest
        request (the JAX engine's victim when no deadlines are set) and
        retry next tick with its blocks free."""
        self._evict(max(skipped, key=lambda s: self.slots[s].rid))

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

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        last = req.generated[-1] if req.generated else None
        if (len(req.generated) >= req.max_new_tokens
                or (self.eos_id is not None and last == self.eos_id)):
            self._release_slot(slot)
            req.status = RequestStatus.FINISHED
            self._done.append(req)

    # ------------------------------------------------------------- ticks
    def step(self) -> Dict[int, List[int]]:
        """One engine tick: admit queued requests, advance chunked prefill
        under the scheduler's budget, then one batched decode (or
        speculative verify) step for every fully prefilled slot. Returns
        {rid: generated_tokens} for requests that finished."""
        self._ticks += 1
        try:
            self._admit()
            # phase split: bounded prefill, then decode, which runs every
            # tick there is decodable work
            self._prefill_step()
            self._decode_active()
        finally:
            self.scheduler.end_tick()
        out = {req.rid: req.generated for req in self._done}
        self._done.clear()
        return out

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
            self._evict_youngest(skipped)
            return
        tokens = self.last_token[:, None].astype(np.int32)
        nxt = self._run_chunk(tokens, seq, self._slot_sampling(active),
                              phase="decode")
        for i in active:
            if seq[i] == 0:
                continue
            req = self.slots[i]
            req.generated.append(int(nxt[i]))
            self.seq_lens[i] = int(seq[i])   # cached positions now
            self.last_token[i] = int(nxt[i])
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
            self._evict_youngest(skipped)
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
        proposed = accepted = 0
        for i in ready:
            req = self.slots[i]
            ne = int(n_emit[i])
            proposed += int(max_accept[i])
            accepted += ne - 1
            for j in range(ne):
                tok = int(emit[i, j])
                req.generated.append(tok)
                self.last_token[i] = tok
                if (len(req.generated) >= req.max_new_tokens
                        or (self.eos_id is not None and tok == self.eos_id)):
                    break            # _maybe_finish releases the slot
            # cached positions: all but the newest token, as after decode
            self.seq_lens[i] = req.seq_len - 1
            self._maybe_finish(i)
        self.spec_proposed += proposed
        self.spec_accepted += accepted

    def run_to_completion(self, max_ticks: int = 10_000
                          ) -> Dict[int, List[int]]:
        """Tick until no work remains; returns {rid: generated_tokens} for
        finished requests (never-fitting submissions are in
        ``self.rejected``)."""
        out: Dict[int, List[int]] = {}
        ticks = 0
        while self.has_work():
            out.update(self.step())
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("serving engine did not converge")
        return out


# The generic engine picks the adapter itself (the JAX package's names).
LlamaPagedEngine = PagedEngine
GPTPagedEngine = PagedEngine
