"""The port's BERT (``models/bert.py``, written in the port's Paddle API)
against the JAX package's, weights carried over.

A tiny ``BertForPretraining`` (2 layers, S=16) gets numpy-seeded weights
in the JAX package; ``load_jax_layer_state`` carries its state dict
into the port's model key for key. Held: the MLM and NSP logits and the
plain and fused losses to LOSS_ATOL, every parameter's gradient to
GRAD_RTOL of its norm (``assert_grads``: the key projection's bias,
zero in exact arithmetic, below a thousandth of the largest gradient
norm), and three AdamW steps' losses to LOSS_ATOL; the
sequence classifier with an attention mask likewise. On CPU tensors the
attention runs the flash kernels' plain versions (no mask) or the plain
attention (masked). Then the plain K1-K3 at bench.py's small BERT
attention shape (B2 S128 H4 d32, non-causal), which
``test_torch_flash_attention*.py`` does not cover, against the Pallas
kernels in the interpreter.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.ops.pallas.flash_attention as jfa
import paddle_tpu_torch as tp
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import load_jax_layer_state
from paddle_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_plain, flash_attention_fwd_plain)
from torch_paddle_api import assert_grads, assert_same

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
B, S = 2, 16
ADAMW = dict(learning_rate=1e-3, beta1=0.9, beta2=0.95, epsilon=1e-8,
             weight_decay=0.1)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def seeded_state(model, seed=0):
    """numpy weights for every entry of a JAX model's state dict (norm
    gains near 1, small biases, embeddings and projections at scales that
    keep the logits far from uniform)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, p in model.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("norm.weight"):
            arr = 1.0 + 0.1 * rng.randn(*shape)
        elif key.endswith("bias"):
            arr = 0.1 * rng.randn(*shape)
        elif "embeddings" in key:
            arr = 0.5 * rng.randn(*shape)
        else:
            arr = rng.randn(*shape) / np.sqrt(shape[0])
        out[key] = arr.astype(np.float32)
    return out


def pair(cls_name, seed=0, **cfg):
    """(JAX model, port model) of one class with the same weights."""
    jm = getattr(jbert, cls_name)(jbert.BertConfig(**TINY, **cfg))
    state = seeded_state(jm, seed)
    jm.set_state_dict(state)
    tm = getattr(tbert, cls_name)(tbert.BertConfig(**TINY, **cfg))
    load_jax_layer_state(tm, state)
    assert list(tm.state_dict()) == list(jm.state_dict())
    return jm, tm


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], (B, S))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_pretraining_logits_losses_and_grads(fused):
    jm, tm = pair("BertForPretraining", fused_loss=fused)
    ids = _ids()
    outs = []
    for p, m in ((jp, jm), (tp, tm)):
        t = p.to_tensor(ids)
        out = m(t, masked_lm_labels=t,
                next_sentence_labels=p.to_tensor(np.array([0, 1])))
        out[2].backward()
        outs.append(out)
    (jmlm, jnsp, jloss), (tmlm, tnsp, tloss) = outs
    assert_same(jnsp, tnsp, 0, LOSS_ATOL)
    assert_same(jloss, tloss, 0, LOSS_ATOL)
    if not fused:
        assert_same(jmlm, tmlm, 0, LOSS_ATOL)
    else:
        assert jmlm is None and tmlm is None
    assert_grads(jm, tm, GRAD_RTOL)


def test_logits_without_labels():
    jm, tm = pair("BertForPretraining")
    ids = _ids(1)
    tt = np.random.RandomState(2).randint(0, 2, (B, S))
    j = jm(jp.to_tensor(ids), token_type_ids=jp.to_tensor(tt))
    t = tm(tp.to_tensor(ids), token_type_ids=tp.to_tensor(tt))
    assert_same(list(j), list(t), 0, LOSS_ATOL)


def test_three_adamw_steps():
    jm, tm = pair("BertForPretraining", fused_loss=True)
    losses = []
    for p, m in ((jp, jm), (tp, tm)):
        opt = p.optimizer.AdamW(parameters=m.parameters(), **ADAMW)
        run = []
        for step in range(3):
            t = p.to_tensor(_ids(step))
            loss = m(t, masked_lm_labels=t)[2]
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(float(loss.item()))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=LOSS_ATOL)
    assert losses[1][-1] < losses[1][0]


def test_sequence_classification_with_attention_mask():
    jm, tm = pair("BertForSequenceClassification", seed=3)
    ids = _ids(4)
    mask = (np.arange(S)[None, :] < np.array([S, 9])[:, None]).astype(
        np.int64)
    labels = np.array([1, 0])
    outs = []
    for p, m in ((jp, jm), (tp, tm)):
        logits, loss = m(p.to_tensor(ids), attention_mask=p.to_tensor(mask),
                         labels=p.to_tensor(labels))
        loss.backward()
        outs.append([logits, loss])
    assert_same(*outs, 0, LOSS_ATOL)
    assert_grads(jm, tm, GRAD_RTOL)


def test_recompute_waits_for_layer_remat():
    """Ported since: ``recompute=True`` no longer raises; each encoder
    layer runs under ``remat_block``, with the sequence output and every
    gradient of the model without recompute (the JAX package's recompute
    is held in test_torch_to_static_bert.py)."""
    tp.seed(0)
    tm = tbert.BertModel(tbert.BertConfig(**TINY, recompute=True))
    plain = tbert.BertModel(tbert.BertConfig(**TINY))
    plain.set_state_dict(tm.state_dict())
    ids = tp.to_tensor(_ids())
    seqs = []
    for model in (tm, plain):
        seq, pooled = model(ids)
        (seq.sum() + pooled.sum()).backward()
        seqs.append(seq.numpy())
    np.testing.assert_array_equal(seqs[0], seqs[1])
    for (name, a), b in zip(tm.named_parameters(), plain.parameters()):
        if a.grad is None or b.grad is None:    # token types: unused
            assert a.grad is None and b.grad is None, name
            continue
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# ------------------------------------------- K1-K3 plain at BERT's shape
@pytest.fixture
def _interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _bhsd(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _bshd(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


def test_plain_k1_k3_at_bench_small_shape_match_pallas(_interpret):
    b, s, h, d = 2, 128, 4, 32
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    blocks = dict(block_q=64, block_k=64)
    j_out, j_lse = jfa._flash_fwd_bhsd(_bhsd(q), _bhsd(k), _bhsd(v),
                                       causal=False, scale=scale, **blocks)
    j_grads = jfa._flash_bwd_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), j_out,
                                  j_lse, _bhsd(do), causal=False,
                                  scale=scale, **blocks)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_fwd_plain(tq, tk, tv, causal=False)
    np.testing.assert_allclose(out.numpy(), _bshd(j_out, b, h), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(j_lse)[:, :s, 0].reshape(b, h, s),
        rtol=5e-4, atol=5e-5)
    grads = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                      causal=False)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b, h),
                                   rtol=5e-4, atol=5e-5)
