"""The port's ``nn.Transformer``, its decoder and the attention caches
against the JAX package's (``paddle_tpu/nn/layer/transformer.py``).

2 + 2 layers, d_model 32, 4 heads, ffn 64, on the same seeded weights
(``torch_nn_parity.pair``): the full forward (causal target mask, post- and
pre-LN) within RTOL/ATOL and every parameter's gradient norm-wise within
GRAD_RTOL (the JAX side one jitted program); the cached
decode (``TransformerDecoder.gen_cache``, one token a step) against the
JAX cached decode, and in the port against the full recompute; greedy
ids equal over 6 steps; the encoder's cache argument.

The JAX package's ``MultiHeadAttention.forward`` binds ``F`` in a branch
of the function (a local import on the self-attention path), so any
other path (cross-attention, a cache) raises UnboundLocalError there.
``_jax_mha`` runs the JAX forward's own code with that import taken out,
for this file only (the JAX package is not edited).
"""
import inspect
import re
import textwrap

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
import paddle_tpu.nn.layer.transformer as jax_transformer
from torch_nn_parity import (_x, assert_layer_grads, jax_forward,
                             layer_grads, pair, port_layer_grads)
from torch_paddle_api import assert_same

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL = 1e-4
CFG = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
           dim_feedforward=64, dropout=0.0)
VOCAB, STEPS = 11, 6


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


@pytest.fixture(autouse=True)
def _jax_mha(monkeypatch):
    src = textwrap.dedent(inspect.getsource(
        jax_transformer.MultiHeadAttention.forward))
    src = re.sub(r"\n[ ]*from \.\. import functional as F\n", "\n", src)
    scope = {}
    exec(compile(src, jax_transformer.__file__, "exec"),
         jax_transformer.__dict__, scope)
    monkeypatch.setattr(jax_transformer.MultiHeadAttention, "forward",
                        scope["forward"])


def _pair(**kw):
    return pair(lambda p: p.nn.Transformer(**dict(CFG, **kw)), seed=3)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_forward_and_backward(normalize_before):
    jm, tm = _pair(normalize_before=normalize_before)

    def run(package):
        return lambda m, src, tgt: m(
            src, tgt, tgt_mask=package.nn.Transformer
            .generate_square_subsequent_mask(5))
    src, tgt = _x(1, 2, 7, 32), _x(2, 2, 5, 32)
    j_out, j_grads = layer_grads(jm, run(jp), src, tgt)
    t_out, t_grads = port_layer_grads(tm, run(tp), src, tgt)
    assert_same(j_out, t_out, rtol=RTOL, atol=ATOL)
    assert_layer_grads(j_grads, t_grads,
                       [n for n, _ in tm.named_parameters()], GRAD_RTOL)


def test_square_subsequent_mask():
    j = np.asarray(jp.nn.Transformer.generate_square_subsequent_mask(
        4).numpy())
    t = tp.nn.Transformer.generate_square_subsequent_mask(4)
    assert t.dtype == tp.float32
    np.testing.assert_array_equal(t.numpy(), j)


def _cached(p, model, src, tgt):
    """One cached decoder call a target step; (the steps' outputs, the
    cache)."""
    memory = model.encoder(src)
    cache = model.decoder.gen_cache(memory)
    steps = []
    for t in range(tgt.shape[1]):
        out, cache = model.decoder(tgt[:, t:t + 1], memory, cache=cache)
        steps.append(out)
    return p.concat(steps, axis=1), cache


def test_cached_decode():
    """The JAX cached decode (one jitted program), the port's, and the
    port's full recompute under the causal mask agree step by step; the
    caches hold every step's keys."""
    jm, tm = _pair()
    for m in (jm, tm):
        m.eval()
    src, tgt = _x(4, 2, 7, 32), _x(5, 2, 5, 32)
    j_steps, = jax_forward([jm], lambda s, t: _cached(jp, jm, s, t)[0],
                           src, tgt)
    t_steps, cache = _cached(tp, tm, tp.to_tensor(src), tp.to_tensor(tgt))
    np.testing.assert_allclose(t_steps.numpy(), j_steps, rtol=RTOL,
                               atol=ATOL)
    full = tm(tp.to_tensor(src), tp.to_tensor(tgt),
              tgt_mask=tp.nn.Transformer.generate_square_subsequent_mask(5))
    np.testing.assert_allclose(t_steps.numpy(), full.numpy(), rtol=RTOL,
                               atol=ATOL)
    incremental, static = cache[0]
    assert incremental.k.shape == [2, 5, 4, 8]
    assert static.k.shape == [2, 7, 4, 8]
    zipped = tm.decoder.gen_cache(tm.encoder(tp.to_tensor(src)), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def _greedy(p, model, emb, proj, src_ids):
    """Greedy ids through the cached decoder, start token 0."""
    memory = model.encoder(emb(src_ids))
    cache = model.decoder.gen_cache(memory)
    tok = p.zeros([src_ids.shape[0], 1], "int64")
    ids = []
    for _ in range(STEPS):
        out, cache = model.decoder(emb(tok), memory, cache=cache)
        tok = p.argmax(proj(out)[:, -1], axis=-1, keepdim=True)
        ids.append(tok)
    return p.concat(ids, axis=1)


def test_greedy_ids():
    jm, tm = _pair()
    for m in (jm, tm):
        m.eval()
    (je, te), (jh, th) = (pair(lambda p: p.nn.Embedding(VOCAB, 32), seed=4),
                          pair(lambda p: p.nn.Linear(32, VOCAB), seed=5))
    src_ids = np.random.RandomState(6).randint(1, VOCAB, (3, 7))
    j_ids, = jax_forward([jm, je, jh], lambda s: _greedy(jp, jm, je, jh, s),
                         src_ids)
    t_ids = _greedy(tp, tm, te, th, tp.to_tensor(src_ids)).numpy()
    np.testing.assert_array_equal(t_ids, j_ids)


def test_encoder_cache():
    """The encoder layers' incremental caches, step by step."""
    jm, tm = _pair()
    x = _x(7, 2, 4, 32)
    outs = []
    for p, m in ((jp, jm), (tp, tm)):
        enc = m.encoder
        cache = enc.gen_cache(p.to_tensor(x))
        steps = []
        for t in range(4):
            out, cache = enc(p.to_tensor(x[:, t:t + 1]), cache=cache)
            steps.append(np.asarray(out.numpy()))
        outs.append(np.concatenate(steps, 1))
        assert cache[0].k.shape == [2, 4, 4, 8]
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def test_decoder_layer_alone():
    layers = pair(lambda p: p.nn.TransformerDecoderLayer(
        32, 4, 64, dropout=0.0, normalize_before=True), seed=8)
    tgt, mem = _x(9, 2, 3, 32), _x(10, 2, 6, 32)
    outs = [l(p.to_tensor(tgt), p.to_tensor(mem))
            for p, l in ((jp, layers[0]), (tp, layers[1]))]
    assert_same(outs[0], outs[1], rtol=RTOL, atol=ATOL)
