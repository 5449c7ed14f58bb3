"""The port's recurrent layers against the JAX package's
(``paddle_tpu/nn/layer/rnn.py``).

LSTM, GRU and SimpleRNN stacks of 2 layers, bidirectional, batch- and
time-major, the cells and the ``RNN``/``BiRNN`` drivers on the same seeded weights
(``torch_nn_parity.pair``), the outputs and final states within
RTOL/ATOL and every parameter's gradient norm-wise within GRAD_RTOL
(the JAX side one jitted program, ``torch_nn_parity.layer_grads``).
``sequence_length`` (which the JAX package does not take) is held
against the JAX stack run on each sequence cut to its own length: the
same outputs up to each length, zeros past it, the same final states.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_nn_parity import (_x, assert_layer_grads, layer_grads, pair,
                             port_layer_grads)
from torch_paddle_api import assert_same

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL = 1e-4
B, T, I, H = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for t in x for y in _leaves(t)]
    return [x]


def _check(jl, tl, *arrays, run=lambda layer, *ts: layer(*ts)):
    """Outputs and final states, and every parameter's gradient."""
    j_out, j_grads = layer_grads(jl, run, *arrays)
    t_out, t_grads = port_layer_grads(tl, run, *arrays)
    assert_same(j_out, t_out, rtol=RTOL, atol=ATOL)
    assert_layer_grads(j_grads, t_grads,
                       [n for n, _ in tl.named_parameters()], GRAD_RTOL)


STACKS = [("LSTM", False), ("GRU", False), ("GRU", True),
          ("SimpleRNN", False)]


@pytest.mark.parametrize("mode,time_major", STACKS)
def test_stack(mode, time_major):
    """Two bidirectional layers; the names are the JAX package's."""
    jl, tl = pair(lambda p: getattr(p.nn, mode)(
        I, H, num_layers=2, direction="bidirect", time_major=time_major))
    assert [n for n, _ in tl.named_parameters()] == [
        n for n, _ in jl.named_parameters()]
    _check(jl, tl, _x(1, T, B, I) if time_major else _x(1, B, T, I))


@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
def test_sequence_length(mode):
    """Each sequence as if it were alone and cut to its length."""
    lens = np.array([5, 3, 5], np.int64)
    jl, tl = pair(lambda p: getattr(p.nn, mode)(
        I, H, num_layers=2, direction="bidirect"))
    x = _x(2, B, T, I)
    out, state = tl(tp.to_tensor(x), sequence_length=tp.to_tensor(lens))
    out, state = out.numpy(), [s.numpy() for s in _leaves(state)]
    for b, n in enumerate(lens):
        j_out, j_state = jl(jp.to_tensor(x[b:b + 1, :n]))
        np.testing.assert_allclose(out[b:b + 1, :n], np.asarray(
            j_out.numpy()), rtol=RTOL, atol=ATOL)
        assert (out[b, n:] == 0).all()
        for s, js in zip(state, _leaves(j_state)):
            np.testing.assert_allclose(s[:, b:b + 1], np.asarray(js.numpy()),
                                       rtol=RTOL, atol=ATOL)


CELLS = [("LSTMCell", 2), ("GRUCell", 1), ("SimpleRNNCell", 1)]


@pytest.mark.parametrize("cell,n_state", CELLS)
def test_cell_and_drivers(cell, n_state):
    """One step of the cell, then ``RNN`` (reversed) and ``BiRNN`` over
    cells carrying the same weights."""
    _check(*pair(lambda p: getattr(p.nn, cell)(I, H)), _x(4, B, I))
    _check(*pair(lambda p: p.nn.BiRNN(getattr(p.nn, cell)(I, H),
                                      getattr(p.nn, cell)(I, H))),
           _x(5, B, T, I))


def test_reverse_rnn_and_initial_state():
    _check(*pair(lambda p: p.nn.RNN(p.nn.GRUCell(I, H), is_reverse=True,
                                    time_major=True)),
           _x(6, T, B, I), _x(7, B, H))


def test_stack_dropout_draws_between_layers():
    tl = tp.nn.LSTM(I, H, num_layers=2, dropout=0.5)
    x = tp.to_tensor(_x(8, B, T, I))
    a = tl(x)[0].numpy()
    tl.eval()
    b, c = tl(x)[0].numpy(), tl(x)[0].numpy()
    np.testing.assert_array_equal(b, c)
    assert not np.allclose(a, b)
