"""Continuous-batching LLM serving over paged KV caches (counterpart of
``paddle_tpu/inference/serving.py``, greedy GPT path).

Same engine as the JAX package's ``PagedEngine``: a host-side
``BlockManager`` owns the physical-block free list, admission and
eviction are plain Python between ticks, and each tick runs

* the chunked prefill of every slot still prefilling: its prefix is
  left-padded to a multiple of ``block_size`` and fed one ``block_size``
  chunk per program (padded positions sit at negative sequence positions,
  whose cache writes are dropped and whose queries see nothing), then
* one (max_batch, 1) decode step for every fully prefilled slot.

Idle lanes run with seq_len 1 and an all-zero block table, so their
writes land in block 0, the reserved trash block; mid-prefill or
memory-stalled lanes run with seq_len 0, which writes nothing.

The JAX engine donates its cache arrays to a jitted program each tick;
here the caches are per-layer tensors that paged attention updates in
place. The whole forward runs under ``torch.inference_mode()``.

Greedy decoding only in this slice: sampling (whose JAX keys fold the
request id and position into a seed), the phase-split scheduler,
speculative decoding, int8 KV pages and the resilience layer (lifecycle,
deadlines, backpressure) come with later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.place import DeviceLike, resolve_device
from ..nn.functional.paged_attention import block_multihead_attention
from .resilience import RequestStatus

__all__ = ["BlockManager", "Request", "PagedEngine", "GPTPagedEngine",
           "RequestStatus"]


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
    generated: List[int] = field(default_factory=list)
    status: str = RequestStatus.QUEUED

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + len(self.generated)


class _GPTArch:
    """Architecture adapter for GPTForCausalLM (learned positions, fused
    qkv, tied head)."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.num_kv_heads = model.cfg.num_heads
        self.max_positions = model.cfg.max_seq_len

    def forward_chunk(self, tokens, start, attend):
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
        return torch.matmul(x[:, -1:, :], m.wte.weight.t())


def _pick_arch(model):
    from ..models.gpt import GPTForCausalLM
    if isinstance(model, GPTForCausalLM):
        return _GPTArch(model)
    raise TypeError(f"PagedEngine serves GPTForCausalLM in this slice; got "
                    f"{type(model).__name__}")


def _paged_forward(arch, kcs, vcs, tokens, seq_lens, tables):
    """One chunk for a (B, T) token batch: appends the chunk's K/V to the
    per-layer caches (in place) and returns the greedy next id of each
    row (B,)."""
    T = tokens.shape[1]

    def attend(li, q, k, v):
        out, _, _ = block_multihead_attention(
            q, kcs[li], vcs[li], tables, seq_lens, new_k=k, new_v=v,
            causal=True)
        return out

    logits = arch.forward_chunk(tokens, seq_lens - T, attend)
    return torch.argmax(logits[:, -1, :], dim=-1)


class PagedEngine:
    """Continuous-batching greedy engine for GPT over paged KV caches.

    Runs on ``device`` (default the card; ``device="cpu"`` asks for the
    CPU), which must be where the model's parameters live."""

    def __init__(self, model, *, max_batch: int = 8, block_size: int = 16,
                 num_blocks: int = 256, max_blocks_per_seq: int = 32,
                 eos_id: Optional[int] = None, device: DeviceLike = None):
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
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.num_kv_heads = self.arch.num_kv_heads
        # K/V pages live in the model's compute dtype (int8 pages: later)
        self.kv_dtype = param.dtype
        self.bm = BlockManager(num_blocks)
        self._total_usable = num_blocks - 1
        shape = (num_blocks, block_size, self.num_kv_heads, self.head_dim)
        self.kc = [torch.zeros(shape, dtype=self.kv_dtype, device=self.device)
                   for _ in range(cfg.num_layers)]
        self.vc = [torch.zeros(shape, dtype=self.kv_dtype, device=self.device)
                   for _ in range(cfg.num_layers)]

        self.tables = np.zeros((max_batch, max_blocks_per_seq), np.int32)
        self.seq_lens = np.ones((max_batch,), np.int32)  # idle: len 1
        self.last_token = np.zeros((max_batch,), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        #: slot -> chunked-prefill state (padded prefix, chunk cursor)
        self._prefilling: Dict[int, dict] = {}
        self.queue: List[Request] = []
        self.rejected: Dict[int, str] = {}
        self._done: List[Request] = []
        self._rid = 0
        #: seconds of each chunk program, by phase (host clock around work
        #: that ends in a device-to-host copy of the sampled ids)
        self.phase_seconds: Dict[str, List[float]] = {"prefill": [],
                                                      "decode": []}

    # ---------------------------------------------------------------- API
    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    temperature: float = 0.0) -> int:
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("add_request: prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("add_request: max_new_tokens must be >= 1")
        if not temperature >= 0.0:   # also rejects NaN
            raise ValueError("add_request: temperature must be >= 0")
        if temperature > 0.0:
            raise NotImplementedError(
                "sampling (temperature > 0) comes with a later slice")
        max_pos = self.arch.max_positions
        if len(prompt) + max_new_tokens > max_pos:
            raise ValueError(
                f"add_request: prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's position table "
                f"({max_pos})")
        self._rid += 1
        req = Request(self._rid, prompt, max_new_tokens)
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
    def _run_chunk(self, tokens_np, seq_lens_np, tables_np,
                   phase: str) -> np.ndarray:
        # serving runs eval mode; the caller's training flag is restored
        was_training = self.model.training
        if was_training:
            self.model.eval()
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                dev = self.device
                nxt = _paged_forward(
                    self.arch, self.kc, self.vc,
                    torch.from_numpy(np.ascontiguousarray(tokens_np)).to(
                        dev, torch.int64),
                    torch.from_numpy(np.ascontiguousarray(seq_lens_np)).to(
                        dev, torch.int64),
                    torch.from_numpy(np.ascontiguousarray(tables_np)).to(
                        dev, torch.int64))
                out = nxt.cpu().numpy()
        finally:
            if was_training:
                self.model.train()
        self.phase_seconds[phase].append(time.perf_counter() - t0)
        return out

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
        """Run every pending chunked prefill to its end: each program
        carries the next chunk of every prefilling slot (slots at
        different chunk indices share one program; per-slot seq_lens
        place the writes). A slot's final chunk yields its first token."""
        bs = self.block_size
        while self._prefilling:
            tokens = np.zeros((self.max_batch, bs), np.int32)
            seq = np.zeros((self.max_batch,), np.int32)   # 0 = inactive
            finalists = []
            for slot, st in sorted(self._prefilling.items()):
                j = st["next"]
                tokens[slot] = st["prefix"][j * bs:(j + 1) * bs]
                seq[slot] = (j + 1) * bs - st["pad"]
                st["next"] = j + 1
                if st["next"] == st["n_chunks"]:
                    finalists.append(slot)
            nxt = self._run_chunk(tokens, seq, self.tables, "prefill")
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
        """One engine tick: admit queued requests, run pending prefills,
        then one batched decode step for every fully prefilled slot.
        Returns {rid: generated_tokens} for requests that finished."""
        self._admit()
        self._prefill_step()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._prefilling]
        if active:
            self._decode_plain(active)
        out = {req.rid: req.generated for req in self._done}
        self._done.clear()
        return out

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
            # every active slot is stalled on memory: preempt the youngest
            # and retry next tick with its blocks free
            self._evict(max(skipped, key=lambda s: self.slots[s].rid))
            return
        tokens = self.last_token[:, None].astype(np.int32)
        nxt = self._run_chunk(tokens, seq, self.tables, "decode")
        for i in active:
            if seq[i] == 0:
                continue
            req = self.slots[i]
            req.generated.append(int(nxt[i]))
            self.seq_lens[i] = int(seq[i])   # cached positions now
            self.last_token[i] = int(nxt[i])
            self._maybe_finish(i)

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


# The generic engine picks the adapter itself (JAX package's name kept).
GPTPagedEngine = PagedEngine
