"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``): the
cells ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the ``RNN`` and
``BiRNN`` drivers, and ``RNNBase`` with ``SimpleRNN``, ``LSTM`` and
``GRU``, with the JAX package's gate orders (LSTM i, f, g, o; GRU r, z,
c) and parameter names (``weight_ih``, ``weight_hh``, ``bias_ih``,
``bias_hh``; a stack's cells are ``cells.<layer * directions + d>``).

The time loop is plain ops, one step after another, inside one
dispatched op a stack (the JAX package's one ``lax.scan``); cuDNN's RNN
is not used. ``sequence_length`` masks the steps past each length: the
state stays, the output is 0, and the reverse direction starts at each
sequence's own last step (Paddle's contract; the JAX package raises on
it). A stack's inter-layer dropout draws from the device's Paddle-API
generator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core import dispatch
from ...core.generator import default_generator
from ...core.tensor import Tensor, as_tensor
from ..initializer import Uniform
from ..parameter import ParamAttr
from .container import LayerList
from .layers import Layer


def _uniform_attr(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return ParamAttr(initializer=Uniform(-k, k))


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


class RNNCellBase(Layer):
    """A cell's parameters and its initial state."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """[batch, *shape] filled with ``init_value``, in the reference's
        dtype, on its device."""
        ref = _t(batch_ref)._data
        shape = shape or (self.hidden_size,)
        return Tensor(torch.full((ref.shape[batch_dim_idx],) + tuple(shape),
                                 init_value, dtype=ref.dtype,
                                 device=ref.device))

    @property
    def state_shape(self):
        raise NotImplementedError

    def gate_params(self):
        """(weight_ih, weight_hh, bias_ih, bias_hh)."""
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)

    def _create(self, input_size, hidden_size, gates, weight_ih_attr,
                weight_hh_attr, bias_ih_attr, bias_hh_attr):
        self.input_size = input_size
        self.hidden_size = hidden_size
        attr = _uniform_attr(hidden_size)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], attr=weight_ih_attr or attr)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], attr=weight_hh_attr or attr)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], attr=bias_ih_attr or attr, is_bias=True)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], attr=bias_hh_attr or attr, is_bias=True)


class SimpleRNNCell(RNNCellBase):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh), act tanh or relu."""

    n_gates = 1

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.activation = activation
        self._create(input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @staticmethod
    def step(params, x, h, activation="tanh"):
        w_ih, w_hh, b_ih, b_hh = params
        z = x @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh
        h_new = torch.tanh(z) if activation == "tanh" else torch.relu(z)
        return h_new, h_new

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        out = dispatch.call(
            "simple_rnn_cell", lambda x, hh, *w: self.step(
                w, x, hh, self.activation),
            [_t(inputs), h, *self.gate_params()])
        return out[0], out[1]

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o: c' = f c + i g, h' = o tanh(c')."""

    n_gates = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._create(input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @staticmethod
    def step(params, x, state, activation=None):
        w_ih, w_hh, b_ih, b_hh = params
        h, c = state
        gates = x @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states

        def body(x, hh, cc, *w):
            h_new, (_, c_new) = self.step(w, x, (hh, cc))
            return h_new, c_new
        out = dispatch.call("lstm_cell", body,
                            [_t(inputs), h, c, *self.gate_params()])
        return out[0], (out[0], out[1])

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    """Gates r, z, c: c = tanh(x_c + r h_c), h' = (1 - z) c + z h."""

    n_gates = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._create(input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @staticmethod
    def step(params, x, h, activation=None):
        w_ih, w_hh, b_ih, b_hh = params
        rx, zx, cx = (x @ w_ih.t() + b_ih).chunk(3, dim=-1)
        rh, zh, ch = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        c = torch.tanh(cx + r * ch)
        h_new = (1.0 - z) * c + z * h
        return h_new, h_new

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        out = dispatch.call("gru_cell", lambda x, hh, *w: self.step(w, x, hh),
                            [_t(inputs), h, *self.gate_params()])
        return out[0], out[1]

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _scan(cell_cls, params, xs, state, activation, reverse=False,
          lengths: Optional[torch.Tensor] = None):
    """The cell over time: xs [T, B, I] -> (outputs [T, B, H], final
    state). Steps at or past ``lengths`` keep the state and give 0."""
    lstm = isinstance(state, tuple)
    outs = [None] * xs.shape[0]
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for t in steps:
        out, new = cell_cls.step(params, xs[t], state, activation)
        if lengths is not None:
            live = (t < lengths)[:, None]
            out = torch.where(live, out, torch.zeros_like(out))
            new = (tuple(torch.where(live, n, s) for n, s in zip(new, state))
                   if lstm else torch.where(live, new, state))
        outs[t], state = out, new
    return torch.stack(outs), state


class RNN(Layer):
    """One cell driven over the time dim (reverse with ``is_reverse``)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.cell
        x = _t(inputs)
        lstm = isinstance(cell, LSTMCell)
        if initial_states is None:
            h0 = cell.get_initial_states(x, batch_dim_idx=int(
                self.time_major))
            init = [h0, Tensor(h0._data.clone())] if lstm else [h0]
        else:
            init = list(initial_states) if lstm else [initial_states]
        lens = [] if sequence_length is None else [_t(sequence_length)]
        act = getattr(cell, "activation", None)
        time_major, reverse = self.time_major, self.is_reverse
        n_state = len(init)

        def body(xa, *rest):
            state = tuple(rest[:n_state]) if lstm else rest[0]
            lengths = rest[n_state].long() if lens else None
            w = rest[n_state + len(lens):]
            xs = xa if time_major else xa.transpose(0, 1)
            outs, final = _scan(type(cell), w, xs, state, act, reverse,
                                lengths)
            if not time_major:
                outs = outs.transpose(0, 1)
            return (outs,) + (tuple(final) if lstm else (final,))
        res = dispatch.call("rnn_scan", body,
                            [x, *init, *lens, *cell.gate_params()],
                            differentiable_mask=[True] * (1 + n_state)
                            + [False] * len(lens) + [True] * 4)
        if lstm:
            return res[0], (res[1], res[2])
        return res[0], res[1]


class BiRNN(Layer):
    """Two cells in opposite directions, outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ... import ops
        states = initial_states or (None, None)
        out_fw, st_fw = self.rnn_fw(inputs, states[0], sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, states[1], sequence_length)
        return ops.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


_CELLS = {"SimpleRNN": SimpleRNNCell, "LSTM": LSTMCell, "GRU": GRUCell}


class RNNBase(Layer):
    """A stack of ``num_layers`` (bidirectional: two cells a layer),
    states [num_layers * num_directions, B, H]; ``dropout`` between the
    layers while training."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        if direction == "forward":
            self.num_directions = 1
        elif direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        else:
            raise ValueError(f"unknown direction {direction!r}")
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr,
                  bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)
        if mode == "SimpleRNN":
            kw["activation"] = activation
        self.cells = LayerList()
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else \
                hidden_size * self.num_directions
            for _ in range(self.num_directions):
                self.cells.append(_CELLS[mode](in_sz, hidden_size, **kw))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = _t(inputs)
        lstm = self.mode == "LSTM"
        nl, nd = self.num_layers, self.num_directions
        if initial_states is None:
            ref = x._data
            z = torch.zeros((nl * nd, ref.shape[int(self.time_major)],
                             self.hidden_size), dtype=ref.dtype,
                            device=ref.device)
            init = [Tensor(z), Tensor(z.clone())] if lstm else [Tensor(z)]
        else:
            init = list(initial_states) if lstm else [initial_states]
        lens = [] if sequence_length is None else [_t(sequence_length)]
        params = [p for cell in self.cells for p in cell.gate_params()]
        cell_cls = type(self.cells[0])
        act = getattr(self.cells[0], "activation", None)
        time_major = self.time_major
        p_drop = float(self.dropout or 0.0)
        gen = (default_generator(x._data.device)
               if p_drop > 0.0 and self.training and nl > 1 else None)
        n_state = len(init)

        def body(xa, *rest):
            states = rest[:n_state]
            lengths = rest[n_state].long() if lens else None
            flat = rest[n_state + len(lens):]
            xs = xa if time_major else xa.transpose(0, 1)
            final_h, final_c = [], []
            for layer in range(nl):
                outs_dir = []
                for d in range(nd):
                    idx = layer * nd + d
                    w = flat[idx * 4:(idx + 1) * 4]
                    init_s = ((states[0][idx], states[1][idx]) if lstm
                              else states[0][idx])
                    outs, final = _scan(cell_cls, w, xs, init_s, act,
                                        d == 1, lengths)
                    outs_dir.append(outs)
                    if lstm:
                        final_h.append(final[0])
                        final_c.append(final[1])
                    else:
                        final_h.append(final)
                xs = outs_dir[0] if nd == 1 else torch.cat(outs_dir, dim=-1)
                if gen is not None and layer < nl - 1:
                    keep = torch.rand(xs.shape, generator=gen,
                                      device=xs.device) < 1.0 - p_drop
                    xs = torch.where(keep, xs / (1.0 - p_drop),
                                     torch.zeros_like(xs))
            out = xs if time_major else xs.transpose(0, 1)
            if lstm:
                return out, torch.stack(final_h), torch.stack(final_c)
            return out, torch.stack(final_h)
        res = dispatch.call(f"{self.mode.lower()}_stack", body,
                            [x, *init, *lens, *params],
                            differentiable_mask=[True] * (1 + n_state)
                            + [False] * len(lens) + [True] * len(params))
        if lstm:
            return res[0], (res[1], res[2])
        return res[0], res[1]


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("SimpleRNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
