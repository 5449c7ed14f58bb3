"""Seq2seq decoding (counterpart of ``paddle_tpu/nn/decode.py``):
``Decoder``, ``BeamSearchDecoder`` and ``dynamic_decode``.

Beam bookkeeping is the JAX package's: a finished beam may only extend
with ``end_token`` (log-prob 0 there, -1e9 elsewhere), lengths freeze
once finished, and the final ids come from ``gather_tree`` over the
predicted and parent ids. The beam math works on the Tensors' payloads,
on their device.

``dynamic_decode`` is one host loop: it reads the finished flags after
every step and stops once every beam has finished or, with
``max_step_num``, after step ``max_step_num``. That keeps the JAX
package's contract for its bounded in-graph ``while_loop`` (the same
trimmed length and ids) and for its unbounded host loop.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Callable, Optional

import torch

from ..core.tensor import Tensor, as_tensor

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]

_KINF = 1e9


class Decoder:
    """The decoder contract: ``initialize``, ``step``, ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self) -> bool:
        return False


_State = namedtuple("BeamSearchState",
                    ["cell_states", "log_probs", "finished", "lengths"])
_Output = namedtuple("BeamSearchOutput",
                     ["scores", "predicted_ids", "parent_ids"])


def _map_structure(fn, structure):
    if isinstance(structure, (list, tuple)):
        out = [_map_structure(fn, s) for s in structure]
        return type(structure)(*out) if hasattr(structure, "_fields") \
            else type(structure)(out)
    if isinstance(structure, dict):
        return {k: _map_structure(fn, v) for k, v in structure.items()}
    return fn(structure)


def _leaves(structure):
    if isinstance(structure, (list, tuple)):
        return [x for s in structure for x in _leaves(s)]
    if isinstance(structure, dict):
        return [x for s in structure.values() for x in _leaves(s)]
    return [structure]


def _raw(x) -> torch.Tensor:
    return as_tensor(x)._data


class BeamSearchDecoder(Decoder):
    """Beam search over a cell: ``cell(inputs, states)`` -> (outputs,
    next_states); ``output_fn`` maps outputs to vocabulary logits and
    ``embedding_fn`` token ids to the cell's inputs."""

    OutputWrapper = _Output
    StateWrapper = _State

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[batch, ...] -> [batch * beam, ...], each row repeated."""
        a = _raw(x)
        return Tensor(a.repeat_interleave(beam_size, dim=0))

    def _expand_to_beam_size(self, x):
        a = _raw(x)
        return Tensor(a[:, None].expand(
            (a.shape[0], self.beam_size) + tuple(a.shape[1:])).contiguous())

    def _merge_batch_beams(self, x):
        a = _raw(x)
        return Tensor(a.reshape((-1,) + tuple(a.shape[2:])))

    def _split_batch_beams(self, x):
        a = _raw(x)
        return Tensor(a.reshape((-1, self.beam_size) + tuple(a.shape[1:])))

    @staticmethod
    def _gather(x, indices, batch_size):
        """Per-batch gather along the beam axis."""
        a = _raw(x)
        idx = _raw(indices).long()
        idx = idx.reshape(tuple(idx.shape) + (1,) * (a.dim() - 2)).expand(
            tuple(idx.shape) + tuple(a.shape[2:]))
        return Tensor(a.gather(1, idx))

    def initialize(self, initial_cell_states):
        first = _leaves(initial_cell_states)[0]
        dev = _raw(first).device
        batch = _raw(first).shape[0]
        self.batch_size = batch
        cell_states = _map_structure(self._expand_to_beam_size,
                                     initial_cell_states)
        init_ids = Tensor(torch.full((batch, self.beam_size),
                                     self.start_token, dtype=torch.int32,
                                     device=dev))
        log_probs = torch.full((batch, self.beam_size), -_KINF, device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int32,
                              device=dev)
        inputs = (self.embedding_fn(init_ids) if self.embedding_fn
                  else init_ids)
        state = _State(cell_states, Tensor(log_probs), Tensor(finished),
                       Tensor(lengths))
        return inputs, state, Tensor(finished.clone())

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        la = _raw(logits).float()
        vocab = la.shape[-1]
        step_logp = torch.log_softmax(la, dim=-1)
        noend = torch.full((vocab,), -_KINF, device=la.device)
        noend[self.end_token] = 0.0
        fin = _raw(beam_state.finished)
        step_logp = torch.where(fin[..., None], noend, step_logp)
        log_probs = step_logp + _raw(beam_state.log_probs)[..., None]
        flat = log_probs.reshape(-1, self.beam_size * vocab)
        topk_scores, topk_idx = torch.topk(flat, self.beam_size, dim=-1)
        beam_idx = Tensor(torch.div(topk_idx, vocab, rounding_mode="floor")
                          .to(torch.int32))
        token_idx = (topk_idx % vocab).to(torch.int32)
        next_cell_states = _map_structure(
            lambda x: self._gather(x, beam_idx, self.batch_size),
            next_cell_states)
        next_finished = _raw(self._gather(beam_state.finished, beam_idx,
                                          self.batch_size))
        next_lengths = _raw(self._gather(beam_state.lengths, beam_idx,
                                         self.batch_size))
        next_lengths = next_lengths + (~next_finished).to(torch.int32)
        next_finished = next_finished | (token_idx == self.end_token)
        output = _Output(Tensor(topk_scores), Tensor(token_idx), beam_idx)
        state = _State(next_cell_states, Tensor(topk_scores),
                       Tensor(next_finished), Tensor(next_lengths))
        return output, state

    def step(self, time, inputs, states, **kwargs):
        merged_inputs = _map_structure(self._merge_batch_beams, inputs)
        merged_cell = _map_structure(self._merge_batch_beams,
                                     states.cell_states)
        cell_out, next_cell = self.cell(merged_inputs, merged_cell, **kwargs)
        cell_out = _map_structure(self._split_batch_beams, cell_out)
        next_cell = _map_structure(self._split_batch_beams, next_cell)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        output, state = self._beam_search_step(time, cell_out, next_cell,
                                               states)
        sample_ids = output.predicted_ids
        sample_ids.stop_gradient = True
        next_inputs = (self.embedding_fn(sample_ids) if self.embedding_fn
                       else sample_ids)
        return output, state, next_inputs, state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        from ..ops.search import gather_tree
        return gather_tree(outputs.predicted_ids,
                           outputs.parent_ids), final_states


def _stack_outputs(outputs):
    """Each leaf of the step outputs stacked over time."""
    first = outputs[0]
    leaves = [_leaves(o) for o in outputs]
    stacked = [Tensor(torch.stack([_raw(step[i]) for step in leaves]))
               for i in range(len(leaves[0]))]
    it = iter(stacked)
    return _map_structure(lambda _: next(it), first)


def _decode(decoder, inits, max_step_num, **kwargs):
    """The host loop: it reads every step's finished flags."""
    inputs, states, finished = decoder.initialize(inits)
    dev = _raw(finished).device
    outputs = []
    t = 0
    while True:
        output, next_states, next_inputs, next_finished = decoder.step(
            Tensor(torch.full((1,), t, dtype=torch.int64, device=dev)),
            inputs, states, **kwargs)
        nf = _raw(next_finished)
        if not decoder.tracks_own_finished:
            nf = nf | _raw(finished)
        outputs.append(output)
        inputs, states, finished = next_inputs, next_states, Tensor(nf)
        t += 1
        if bool(nf.all()) or (max_step_num is not None
                              and t > int(max_step_num)):
            break
    return _stack_outputs(outputs), states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every beam finishes or ``max_step_num`` is
    passed; returns (outputs, final states[, lengths]), the outputs
    batch-major unless ``output_time_major``."""
    stacked, states = _decode(decoder, inits, max_step_num, **kwargs)
    seq_lengths = getattr(states, "lengths", None)
    try:
        final_outputs, final_states = decoder.finalize(stacked, states,
                                                       seq_lengths)
    except NotImplementedError:
        final_outputs, final_states = stacked, states
    if not output_time_major:
        final_outputs = _map_structure(
            lambda x: Tensor(_raw(x).transpose(0, 1)), final_outputs)
    if return_length:
        return final_outputs, final_states, seq_lengths
    return final_outputs, final_states
