"""The port's seq2seq decoding against the JAX package's
(``paddle_tpu/nn/decode.py``): ``BeamSearchDecoder`` with
``dynamic_decode`` on its bounded path (``max_step_num``: a fixed loop
and one host read in the port, one ``while_loop`` in the JAX package)
and its host path, and ``gather_tree``.

``tests/test_nn_tail.py::TestBeamSearch``'s two cases run on both
packages; then the same seeded cell, embedding and projection (the JAX
state carried into the port's) decode in both, and the ids, scores,
parent beams, lengths and trimmed lengths agree.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state

PKGS = [pytest.param(jp, id="jax"), pytest.param(tp, id="port")]
V, H = 7, 4


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _build(p):
    emb = p.nn.Embedding(V, H)

    class Cell(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = p.nn.Linear(H, H)

        def forward(self, inputs, states):
            h = (self.lin(inputs) + states).tanh()
            return h, h

    return emb, Cell(), p.nn.Linear(H, V)


def _t(p, a):
    return p.to_tensor(np.asarray(a))


# --------------------------- test_nn_tail.py::TestBeamSearch's two cases
@pytest.mark.parametrize("p", PKGS)
def test_decode_shapes_and_end_token(p):
    p.seed(0)       # the weights, whatever ran before in this process
    emb, cell, out = _build(p)
    dec = p.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                 beam_size=3, embedding_fn=emb,
                                 output_fn=out)
    init = _t(p, np.random.RandomState(7).randn(2, 4).astype(np.float32))
    outs, final = p.nn.dynamic_decode(dec, inits=init, max_step_num=6)
    ids = np.asarray(outs.numpy() if hasattr(outs, "numpy")
                     else outs[0].numpy())
    assert ids.shape[0] == 2 and ids.shape[2] == 3
    assert (ids == 1).any()


@pytest.mark.parametrize("p", PKGS)
def test_greedy_equals_beam1(p):
    p.seed(1)
    emb, cell, out = _build(p)
    dec = p.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                 beam_size=1, embedding_fn=emb,
                                 output_fn=out)
    init_np = np.random.RandomState(8).randn(1, 4).astype(np.float32)
    outs, _ = p.nn.dynamic_decode(dec, inits=_t(p, init_np), max_step_num=5)
    ids = np.asarray((outs if not isinstance(outs, tuple)
                      else outs[0]).numpy()).reshape(-1)
    h, tok, got = init_np, np.array([0]), []
    for _ in range(len(ids)):
        e = np.asarray(emb(_t(p, tok)).numpy())
        h = np.tanh(np.asarray(cell.lin(_t(p, e)).numpy()) + h)
        tok = np.array([int(np.argmax(np.asarray(out(_t(p, h)).numpy())[0]))])
        got.append(int(tok[0]))
        if got[-1] == 1:
            break
    np.testing.assert_array_equal(ids[:len(got)], got)


# ------------------------------------------------ the packages side by side
def _pair():
    parts = []
    for p in (jp, tp):
        p.seed(11)
        parts.append(_build(p))
    for j, t in zip(*parts):
        load_jax_layer_state(t, {k: np.asarray(v.numpy())
                                 for k, v in j.state_dict().items()})
    return parts


@pytest.mark.parametrize("max_step,host,end,beam", [
    (3, False, 2, 3), (12, False, 0, 2), (12, True, 2, 3)])
def test_beam_search_matches(max_step, host, end, beam):
    """Bounded decodes (4 steps, cut before the beams end; 13 steps at
    most, trimmed to the 3 after which every beam has ended) and the host
    loop (``impute_finished``)."""
    parts = _pair()
    init = np.random.RandomState(12).randn(3, H).astype(np.float32)
    res = []
    for p, (emb, cell, out) in zip((jp, tp), parts):
        dec = p.nn.BeamSearchDecoder(cell, 0, end, beam, embedding_fn=emb,
                                     output_fn=out)
        ids, state, lens = p.nn.dynamic_decode(
            dec, inits=p.to_tensor(init), max_step_num=max_step,
            impute_finished=host, return_length=True)
        res.append([np.asarray(x.numpy()) for x in
                    (ids, state.log_probs, state.finished, lens)])
    for j, t in zip(*res):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    assert res[1][0].shape[1] == (3 if end == 0 else max_step + 1)


def test_bounded_equals_host_loop():
    """A bound that the beams never reach changes nothing: the decode
    with ``max_step_num`` gives the unbounded loop's ids, stopped at the
    step that ends the last beam."""
    (emb, cell, out), = _pair()[1:]
    init = tp.to_tensor(np.random.RandomState(13).randn(2, H).astype(
        np.float32))
    dec = tp.nn.BeamSearchDecoder(cell, 0, 3, 2, embedding_fn=emb,
                                  output_fn=out)
    a = tp.nn.dynamic_decode(dec, inits=init, max_step_num=20)[0].numpy()
    assert a.shape[1] <= 20
    b = tp.nn.dynamic_decode(dec, inits=init)[0].numpy()
    np.testing.assert_array_equal(a, b)


def test_gather_tree_backtrace():
    ids = np.array([[[2, 5]], [[7, 3]], [[1, 4]]], np.int64)
    parents = np.array([[[0, 0]], [[1, 0]], [[1, 1]]], np.int64)
    got = tp.nn.functional.gather_tree(tp.to_tensor(ids),
                                       tp.to_tensor(parents)).numpy()
    want = np.asarray(jp.nn.functional.gather_tree(
        jp.to_tensor(ids), jp.to_tensor(parents)).numpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0, 0], [2, 3, 1])
