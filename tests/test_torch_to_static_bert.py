"""``to_static`` over the port's Paddle-API BERT against the JAX
package's ``to_static``, weights carried over by
``models/convert.load_jax_layer_state``.

The port records the dispatcher's op stream on a signature's first call
and replays it (fused with ``FLAGS_enable_fusion``) on the next; each
case records on one batch and replays on another of the same shape, so
a value baked into the program would show. The JAX fused program runs
its Pallas kernels in the interpreter (``INTERPRET``), as the JAX
package's own tests run them on the CPU.

Held, in fp32: the MLM and NSP logits of the replay within OUT_TOL of
the JAX ``to_static``'s; the loss within LOSS_TOL and every gradient
within GRAD_RTOL of its norm (by depth) of ``jax.value_and_grad`` over the JAX
program (the fused one with the flag on); the pass's
``matched``/``rewritten``/``rejected`` equal to the JAX package's, which
are the counts below. Under O1 bf16 the fused program against the JAX
fused program at the O1 tolerances of ``test_torch_gpt.py``. With
``recompute=True``: eager against the JAX eager recompute and against no
recompute, and the fused recomputed program against the JAX fused
program without recompute (the JAX ``to_static`` with fusion and
recompute raises, ROADMAP Queue 3).

Each JAX program's results are computed once a module (``jax_results``,
by depth, batch, amp level and fusion flag) and shared by the cases that
hold a port program to the same JAX program.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.lazy_init import LazyGuard
from paddle_tpu.ops.pallas import fused_ops as JK
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import load_jax_layer_state
from test_torch_bert import seeded_state
from test_torch_gpt import O1_GRAD_RTOL, O1_LOSS_RTOL
from torch_vision_zoo import lazy_jax

OUT_TOL = 1e-5
LOSS_TOL = 1e-5
# gradients norm-wise: 2 layers; 12 layers, whose query projections fp32
# computes in either package to a few 1e-4 of their norm (against a
# float64 run of the port at layer 3: the port 2.6e-4, JAX 4.8e-4)
GRAD_RTOL = {2: 1e-4, 12: 1e-3}
# a gradient below this share of the largest gradient norm is held to
# that scale instead of its own: in fp32 the deep layers' query and key
# projections (1e-12 to 1e-9 of the largest, behind saturated softmax
# rows) are rounding noise in both packages
TINY_GRAD = 1e-4
# the JAX package's probe size: 12 layers of hidden 128, 2 heads of 64
BASE = dict(vocab_size=512, hidden_size=128, num_attention_heads=2,
            intermediate_size=512, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 2, 64
STAT_KEYS = ("matched", "rewritten", "rejected")
# the JAX pass's counts on BertForPretraining (two residual norms and one
# linear+gelu a layer, the MLM head's linear+gelu; the embeddings' norm
# feeds the first QKV projection and the residual add, so it stays)
WANT = {12: {"matched": {"norm_linear": 1, "residual_norm": 24,
                         "linear_act": 13},
             "rewritten": {"residual_norm": 24, "linear_act": 13},
             "rejected": {"norm_linear": 1}},
        2: {"matched": {"norm_linear": 1, "residual_norm": 4,
                        "linear_act": 3},
            "rewritten": {"residual_norm": 4, "linear_act": 3},
            "rejected": {"norm_linear": 1}}}


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


@pytest.fixture(params=[False, True], ids=["unfused", "fused"])
def fusion(request):
    old = JK.INTERPRET
    JK.INTERPRET = True
    jp.set_flags({"FLAGS_enable_fusion": request.param})
    tp.set_flags({"FLAGS_enable_fusion": request.param})
    yield request.param
    JK.INTERPRET = old
    jp.set_flags({"FLAGS_enable_fusion": False})
    tp.set_flags({"FLAGS_enable_fusion": False})


_STATES = {}


def state_of(layers):
    """The seeded weights of a JAX BertForPretraining of ``layers``."""
    if layers not in _STATES:
        with LazyGuard():
            _STATES[layers] = seeded_state(jbert.BertForPretraining(
                jbert.BertConfig(**BASE, num_hidden_layers=layers)))
    return _STATES[layers]


def jax_model(layers, **cfg):
    """The JAX model on ``state_of(layers)``, built under ``LazyGuard``
    (its initializers would compile per shape)."""
    return lazy_jax(lambda: jbert.BertForPretraining(jbert.BertConfig(
        **BASE, num_hidden_layers=layers, **cfg)), lambda j: state_of(layers))


def port_model(layers, **cfg):
    tm = tbert.BertForPretraining(tbert.BertConfig(
        **BASE, num_hidden_layers=layers, **cfg))
    load_jax_layer_state(tm, state_of(layers))
    return tm


def pair(layers, jax_cfg=None, **cfg):
    """(JAX model, port model) of BertForPretraining, the same weights."""
    return (jax_model(layers, **dict(cfg, **(jax_cfg or {}))),
            port_model(layers, **cfg))


_JAX = {}


def jax_results(layers, seed, fused, level="O0"):
    """``jax_program`` of a fresh JAX model of ``layers`` on ``batch(seed)``
    with the fusion flag ``fused`` (set by the caller), once a module."""
    key = (layers, seed, fused, level)
    if key not in _JAX:
        _JAX[key] = jax_program(jax_model(layers), batch(seed), level)
    return _JAX[key]


def batch(seed):
    return np.random.RandomState(seed).randint(0, BASE["vocab_size"], (B, S))


def jax_program(jm, ids, level="O0"):
    """The JAX ``to_static`` program's logits, and its loss and
    gradients (by name) under ``jax.value_and_grad`` and
    ``auto_cast(level)``, with its pass's stats: one program, whose
    logits come out beside the loss."""
    jp.jit.to_static(jm, full_graph=True)
    named = list(jm.named_parameters())
    params = [p for _, p in named]

    def loss_of(arrays):
        originals = [p._data for p in params]
        for p, a in zip(params, arrays):
            p._data = a
        try:
            t = JTensor(jnp.asarray(ids))
            with jamp.auto_cast(level=level, dtype="bfloat16"):
                mlm, nsp, loss = jm(t, masked_lm_labels=t)
            return loss._data.astype(jnp.float32), (mlm._data, nsp._data)
        finally:
            for p, o in zip(params, originals):
                p._data = o

    (loss, logits), grads = jax.value_and_grad(loss_of, has_aux=True)(
        [p._data for p in params])
    return ([np.asarray(o) for o in logits], float(loss),
            {n: np.asarray(g.astype(jnp.float32))
             for (n, _), g in zip(named, grads)}, jm.forward.fusion_stats)


def port_program(tm, ids, record_ids, level="O0"):
    """The port's program: each signature recorded on ``record_ids``,
    then replayed on ``ids``. Returns the logits, the loss, the
    gradients by name and the pass's stats."""
    static = tp.jit.to_static(tm, full_graph=True)
    static(tp.to_tensor(record_ids))
    logits = [o.numpy() for o in static(tp.to_tensor(ids))]
    for i in (record_ids, ids):
        t = tp.to_tensor(i)
        with amp.auto_cast(level=level, dtype="bfloat16"):
            loss = static(t, masked_lm_labels=t)[2]
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()
             if p.grad is not None}
    return logits, float(loss.numpy()), grads, tm.forward.fusion_stats


def assert_grads_close(got, want, rtol):
    """Gradients by name, norm-wise; a parameter the loss does not reach
    has no gradient on the port and a zero one from ``value_and_grad``."""
    for name in set(want) - set(got):
        assert not np.any(want[name]), name
    assert set(got) <= set(want)
    want = {n: g for n, g in want.items() if n in got}
    largest = max(np.linalg.norm(g) for g in want.values())
    for name, g in want.items():
        if name.endswith("k_proj.bias"):     # zero in exact arithmetic
            assert np.abs(got[name]).max() <= 1e-3 * largest, name
            continue
        scale = max(np.linalg.norm(g), TINY_GRAD * largest)
        err = np.linalg.norm(got[name] - g) / scale
        assert err <= rtol, (name, err, np.linalg.norm(g) / largest)


@pytest.mark.parametrize("layers", [2, 12])
def test_bert_program_matches_jax_to_static(layers, fusion):
    ids = batch(1)
    j_logits, j_loss, j_grads, j_stats = jax_results(layers, 1, fusion)
    logits, loss, grads, stats = port_program(port_model(layers), ids,
                                              batch(2))
    for got, want in zip(logits, j_logits):
        np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    assert abs(loss - j_loss) <= LOSS_TOL * max(abs(j_loss), 1.0)
    assert_grads_close(grads, j_grads, GRAD_RTOL[layers])
    if not fusion:
        assert stats is None and j_stats is None
        return
    assert {k: stats[k] for k in STAT_KEYS} == \
        {k: j_stats[k] for k in STAT_KEYS} == WANT[layers]


@pytest.mark.parametrize("layers", [2, 12])
def test_bert_o1_fused_program_matches_jax(layers):
    """O1 bf16 with fp32 weights: the same rewrites as in fp32, and the
    fused program's loss within O1_LOSS_RTOL and its whole gradient within
    O1_GRAD_RTOL norm-wise of the JAX fused program's. Not each
    parameter's: bf16 rounds in other places in the two packages, enough
    to move a value projection's bias (a sum over every position) by more
    (2.4% apart at 2 layers in the unfused programs, 3.6% at 12)."""
    old = JK.INTERPRET
    JK.INTERPRET = True
    jp.set_flags({"FLAGS_enable_fusion": True})
    tp.set_flags({"FLAGS_enable_fusion": True})
    try:
        ids = batch(3)
        _, j_loss, j_grads, j_stats = jax_results(layers, 3, True, "O1")
        _, loss, grads, stats = port_program(port_model(layers), ids,
                                             batch(4), "O1")
    finally:
        JK.INTERPRET = old
        jp.set_flags({"FLAGS_enable_fusion": False})
        tp.set_flags({"FLAGS_enable_fusion": False})
    assert {k: stats[k] for k in STAT_KEYS} == \
        {k: j_stats[k] for k in STAT_KEYS} == WANT[layers]
    assert abs(loss - j_loss) <= O1_LOSS_RTOL * abs(j_loss), (loss, j_loss)
    for name in set(j_grads) - set(grads):
        assert not np.any(j_grads[name]), name
    names = sorted(grads)
    got = np.concatenate([grads[n].ravel() for n in names])
    want = np.concatenate([j_grads[n].ravel() for n in names])
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= O1_GRAD_RTOL, err


def _eager_loss_and_grads(model, ids, jax_side):
    if jax_side:
        t = JTensor(jnp.asarray(ids))
    else:
        t = tp.to_tensor(ids)
    loss = model(t, masked_lm_labels=t)[2]
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in model.named_parameters()
             if p.grad is not None}
    return float(np.asarray(loss.numpy())), grads


def test_bert_recompute_eager_matches_jax_and_no_recompute():
    """``recompute=True`` trains eagerly: the loss and gradients of the
    JAX model with recompute and of the port's without."""
    jm, tm = pair(2, recompute=True)
    plain = port_model(2)
    ids = batch(5)
    j_loss, j_grads = _eager_loss_and_grads(jm, ids, True)
    loss, grads = _eager_loss_and_grads(tm, ids, False)
    p_loss, p_grads = _eager_loss_and_grads(plain, ids, False)
    assert abs(loss - j_loss) <= LOSS_TOL * max(abs(j_loss), 1.0)
    assert_grads_close(grads, j_grads, GRAD_RTOL[2])
    assert loss == p_loss
    for name, g in p_grads.items():
        np.testing.assert_array_equal(grads[name], g, err_msg=name)


def test_bert_fused_recompute_matches_jax_fused_without_recompute(fusion):
    """The fused, recomputed program against the JAX program without
    recompute (the function is the same): the pass runs inside each
    checkpointed layer, and the embeddings' norm no longer meets the first
    projection, which is inside the first layer's region. The JAX
    program is ``test_bert_program_matches_jax_to_static``'s, on its
    batch."""
    ids = batch(1)
    j_logits, j_loss, j_grads, _ = jax_results(12, 1, fusion)
    logits, loss, grads, stats = port_program(
        port_model(12, recompute=True), ids, batch(7))
    for got, want in zip(logits, j_logits):
        np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    assert abs(loss - j_loss) <= LOSS_TOL * max(abs(j_loss), 1.0)
    assert_grads_close(grads, j_grads, GRAD_RTOL[12])
    if fusion:
        assert stats["rewritten"] == WANT[12]["rewritten"]
        assert stats["rejected"] == {}
