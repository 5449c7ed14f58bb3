"""The port's fusion pass and ``to_static`` against the JAX package's.

* ``fuse_steps``: the port's copy against ``paddle_tpu.compile.fusion`` on
  the same hand-built record lists (each pattern, the rejections of
  ``tests/test_fusion.py``, a producer-order hazard): the same plans,
  patterns and stats.
* ``to_static`` with ``FLAGS_enable_fusion`` over the tiny GPT-2 and LLaMA
  (MHA and GQA): the same ``fusion_stats`` as the JAX ``to_static`` on the
  same configuration, and outputs within 1e-4 of the JAX fused program on
  carried weights (its Pallas kernels interpreted).
* With the flag off, ``to_static`` is bit-equal to eager and runs no pass.
* Under amp O1 bf16 with the fused loss, ``llama_tiny`` (B2 S32) gets the
  JAX ``to_static``'s ``fusion_stats``, and two fused AdamW steps keep the
  losses and gradients of the JAX fused steps within the O1 tolerances of
  ``test_torch_gpt``.
* With ``recompute``, the JAX ``to_static`` + fusion raises
  (``UnexpectedTracerError``, a fault of the reference); the port's fused
  and recomputed step is held to the JAX fused step without recompute
  (recompute does not change the function), and its pass runs inside each
  checkpointed block.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax
import jax.numpy as jnp

from paddle_tpu import amp as jamp
from paddle_tpu.compile import fusion as jfusion
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_ops as JK
from paddle_tpu_torch import amp, get_flag, set_flags, to_static
from paddle_tpu_torch.compile import fusion
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_jax_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from test_torch_gpt import assert_o1_close, port_amp_loss_and_grads
from test_torch_gpt import seeded_state as gpt_state
from test_torch_llama import seeded_state as llama_state

TOL = 1e-4
GPT_TINY = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
                max_seq_len=64)
LLAMA_TINY = dict(vocab_size=96, hidden_size=128, intermediate_size=256,
                  num_layers=2, num_heads=2, max_seq_len=64)
LLAMA_GQA = dict(LLAMA_TINY, num_heads=4, num_kv_heads=2)
STAT_KEYS = ("matched", "rewritten", "rejected", "patterns")


class Rec:
    """A record as both passes read it."""

    def __init__(self, name, ins, outs, in_shapes, out_shapes, **attrs):
        self.name = name
        self.in_ids, self.out_ids = tuple(ins), tuple(outs)
        self.in_shapes, self.out_shapes = tuple(in_shapes), tuple(out_shapes)
        self.attrs = attrs


def norm(kind, x, out, shape, *wb, has_w=False, has_b=False):
    return Rec(kind, (x,) + wb, (out,), (shape,) + ((shape[-1:],) * len(wb)),
               (shape,), epsilon=1e-5, norm_ndim=1, has_w=has_w, has_b=has_b)


def linear(x, w, out, xs, n, bias=None):
    ins = (x, w) + ((bias,) if bias else ())
    shapes = (xs, (xs[-1], n)) + (((n,),) if bias else ())
    return Rec("linear", ins, (out,), shapes, (xs[:-1] + (n,),))


def unary(name, x, out, shape, **attrs):
    return Rec(name, (x,), (out,), (shape,), (shape,), **attrs)


def add(a, b, out, sa, sb, so):
    return Rec("add", (a, b), (out,), (sa, sb), (so,))


X, BSX = (4, 32), (2, 8, 32)
CASES = {
    "norm_linear_act": ([norm("layer_norm", "x", "h", X),
                         linear("h", "w", "y", X, 64, bias="b"),
                         unary("gelu", "y", "z", (4, 64), approximate=False)],
                        {"z"}),
    "gelu_tanh_rms": ([norm("rms_norm", "x", "h", X),
                       linear("h", "w", "y", X, 64),
                       unary("gelu", "y", "z", (4, 64), approximate=True)],
                      {"z"}),
    "norm_weight_and_bias": ([norm("layer_norm", "x", "h", X, "nw", "nb",
                                   has_w=True, has_b=True),
                              linear("h", "w", "y", X, 64)], {"y"}),
    "interior_fetch_rejects": ([norm("layer_norm", "x", "h", X),
                                linear("h", "w", "y", X, 64),
                                unary("gelu", "y", "z", (4, 64))],
                               {"h", "z"}),
    "interior_multi_consumer_rejects": ([norm("layer_norm", "x", "h", X),
                                         linear("h", "w", "y", X, 64),
                                         unary("gelu", "y", "z", (4, 64)),
                                         unary("scale", "h", "h2", X)],
                                        {"z", "h2"}),
    "residual_external_sum": ([add("x", "y", "s", BSX, BSX, BSX),
                               norm("rms_norm", "s", "n", BSX),
                               Rec("mean", ("s",), ("m",), (BSX,), ((),))],
                              {"n", "m"}),
    "bias_act": ([add("x", "b", "u", X, (32,), X),
                  unary("silu", "u", "v", X)], {"v"}),
    "bias_act_multi_consumer_rejects": ([add("x", "b", "u", X, (32,), X),
                                         unary("relu", "u", "v", X),
                                         unary("exp", "u", "e", X)],
                                        {"v", "e"}),
    "linear_act": ([linear("x", "w", "y", X, 64),
                    unary("relu", "y", "z", (4, 64))], {"z"}),
    "linear_external_rejects": ([linear("x", "w", "y", X, 64),
                                 unary("relu", "y", "z", (4, 64))],
                                {"y", "z"}),
    "rope_proj": ([linear("x", "w", "y", BSX, 64),
                   Rec("reshape", ("y",), ("r",), ((2, 8, 64),),
                       ((2, 8, 4, 16),)),
                   Rec("rotary_embedding", ("r",), ("q",), ((2, 8, 4, 16),),
                       ((2, 8, 4, 16),), theta=10000.0, pos_offset=3)],
                  {"q"}),
    "rope_tensor_offset_stays": ([linear("x", "w", "y", BSX, 64),
                                  Rec("reshape", ("y",), ("r",),
                                      ((2, 8, 64),), ((2, 8, 4, 16),)),
                                  Rec("rotary_embedding", ("r",), ("q",),
                                      ((2, 8, 4, 16),), ((2, 8, 4, 16),))],
                                 {"q"}),
    "rope_reshape_external_rejects": ([linear("x", "w", "y", BSX, 64),
                                       Rec("reshape", ("y",), ("r",),
                                           ((2, 8, 64),), ((2, 8, 4, 16),)),
                                       Rec("rotary_embedding", ("r",), ("q",),
                                           ((2, 8, 4, 16),), ((2, 8, 4, 16),),
                                           theta=10000.0, pos_offset=0)],
                                      {"q", "r"}),
    "producer_order_hazard_rejects": ([norm("layer_norm", "x", "h", X),
                                       unary("transpose", "w0", "w", (64, 32)),
                                       linear("h", "w", "y", X, 64),
                                       unary("gelu", "y", "z", (4, 64))],
                                      {"z"}),
    "two_residual_blocks": ([add("x", "a", "s1", BSX, BSX, BSX),
                             norm("layer_norm", "s1", "n1", BSX, "g", "b",
                                  has_w=True, has_b=True),
                             linear("n1", "w", "m", BSX, 32),
                             add("s1", "m", "s2", BSX, BSX, BSX),
                             norm("layer_norm", "s2", "n2", BSX)], {"n2"}),
    "unrelated_pass_through": ([unary("tanh", "x", "y", X),
                                unary("multiply", "y", "z", X)], {"z"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fuse_steps_matches_jax(case):
    steps, external = CASES[case]
    plan, stats = fusion.fuse_steps(steps, external)
    j_plan, j_stats = jfusion.fuse_steps(steps, external)
    assert stats == j_stats
    assert len(plan) == len(j_plan)
    for got, want in zip(plan, j_plan):
        if not getattr(want, "pattern", ""):
            assert got is want                 # passed through untouched
            continue
        for field in ("name", "in_ids", "out_ids", "attrs", "in_shapes",
                      "out_shapes", "pattern"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.fn.fn.__name__ == got.name  # the port's F.fused_* op


@pytest.fixture
def fusion_on():
    old = JK.INTERPRET
    JK.INTERPRET = True
    paddle.set_flags({"FLAGS_enable_fusion": True})
    set_flags({"FLAGS_enable_fusion": True})
    yield
    JK.INTERPRET = old
    paddle.set_flags({"FLAGS_enable_fusion": False})
    set_flags({"FLAGS_enable_fusion": False})


def _pair(family, cfg):
    if family == "gpt":
        jmodel = JaxGPT(JaxGPTConfig(**cfg))
        state = gpt_state(jmodel)
        tmodel = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    else:
        jmodel = JaxLlama(JaxLlamaConfig(**cfg))
        state = llama_state(jmodel)
        tmodel = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    jmodel.set_state_dict(state)
    load_jax_state(tmodel, state)
    return jmodel, tmodel


@pytest.mark.parametrize("family,cfg,with_labels", [
    ("gpt", GPT_TINY, True), ("llama", LLAMA_TINY, True),
    ("llama", LLAMA_GQA, False)], ids=["gpt2-train", "llama-train",
                                       "llama-gqa-logits"])
def test_to_static_fused_matches_jax(family, cfg, with_labels, fusion_on):
    jmodel, tmodel = _pair(family, cfg)
    ids = np.random.RandomState(5).randint(0, cfg["vocab_size"], (2, 16))
    jids, tids = paddle.to_tensor(ids), torch.from_numpy(ids)
    jax_static = paddle.jit.to_static(jmodel, full_graph=True)
    sf = to_static(tmodel)
    if with_labels:
        (j_logits, j_loss), (logits, loss) = (
            jax_static(jids, labels=jids), sf(tids, labels=tids))
        np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                                   atol=TOL, rtol=TOL)
    else:
        j_logits, logits = jax_static(jids), sf(tids)
    j_stats = jax_static.forward.fusion_stats
    assert {k: sf.fusion_stats[k] for k in STAT_KEYS} == {
        k: j_stats[k] for k in STAT_KEYS}
    assert sf.fusion_stats["rewritten"]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(j_logits.numpy()), atol=TOL,
                               rtol=TOL)


def test_bias_act_program_matches_jax(fusion_on):
    rng = np.random.RandomState(6)
    x, w, b = (rng.randn(*s).astype(np.float32) for s in
               ((16, 128), (128, 256), (256,)))
    jax_static = paddle.jit.to_static(
        lambda xa: JF.gelu(paddle.matmul(xa, paddle.to_tensor(w))
                           + paddle.to_tensor(b)), full_graph=True)
    want = jax_static(paddle.to_tensor(x))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    sf = to_static(lambda xt: F.gelu(torch.matmul(xt, tw) + tb))
    got = sf(torch.from_numpy(x))
    assert sf.fusion_stats["rewritten"] == \
        jax_static.fusion_stats["rewritten"] == {"bias_act": 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("family,cfg", [("gpt", GPT_TINY),
                                        ("llama", LLAMA_GQA)])
def test_flag_off_is_bit_equal_to_eager(family, cfg):
    assert get_flag("FLAGS_enable_fusion") is False
    _, tmodel = _pair(family, cfg)
    ids = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg["vocab_size"], (2, 16)))
    sf = to_static(tmodel)
    logits, loss = sf(ids, labels=ids)
    want_logits, want_loss = tmodel(ids, labels=ids)
    assert sf.fusion_stats is None
    assert torch.equal(logits, want_logits) and torch.equal(loss, want_loss)
    loss.backward()
    assert all(p.grad is not None for p in tmodel.parameters())


def test_a_signature_change_retraces(fusion_on):
    _, tmodel = _pair("llama", LLAMA_TINY)
    sf = to_static(tmodel)
    ids = torch.zeros((1, 8), dtype=torch.int64)
    sf(ids)
    first = sf.graph_module
    sf(ids)
    assert sf.graph_module is first
    sf(torch.zeros((2, 8), dtype=torch.int64))
    assert sf.graph_module is not first
    set_flags({"FLAGS_enable_fusion": False})
    sf(ids)
    assert sf.fusion_stats is None


def _jax_fused_loss_and_grads(jmodel, ids, level="O0"):
    """The JAX fused program (``to_static`` with fusion) under
    ``jax.value_and_grad`` and ``auto_cast(level)``, as ``bench.py``'s
    rungs run it: the loss, the gradients by name (JAX layout) and the
    pass's stats."""
    static = paddle.jit.to_static(jmodel, full_graph=True)
    named = list(jmodel.named_parameters())
    params = [p for _, p in named]

    def loss_of(arrays):
        originals = [p._data for p in params]
        for p, a in zip(params, arrays):
            p._data = a
        try:
            with jamp.auto_cast(level=level, dtype="bfloat16"):
                _, loss = jmodel(JTensor(ids), labels=JTensor(ids))
            return loss._data.astype(jnp.float32)
        finally:
            for p, o in zip(params, originals):
                p._data = o

    loss, grads = jax.value_and_grad(loss_of)([p._data for p in params])
    return (float(loss), {n: np.asarray(g.astype(jnp.float32))
                          for (n, _), g in zip(named, grads)},
            static.forward.fusion_stats)


LLAMA_O1 = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=4, max_seq_len=128,
                use_flash_attention=False, fused_loss=True)


def test_o1_fused_loss_stats_and_two_adamw_steps_match_jax(fusion_on):
    """``llama_tiny`` under O1 bf16 with the fused loss, B2 S32: the JAX
    pass's stats (O1 changes no fusion decision), and two fused AdamW steps
    with the losses and gradients of the JAX fused program's."""
    jmodel, tmodel = _pair("llama", LLAMA_O1)
    batches = [np.random.RandomState(30 + i).randint(0, 512, (2, 32))
               for i in range(2)]
    j_opt = paddle.optimizer.AdamW(parameters=jmodel.parameters(),
                                   learning_rate=1e-3, epsilon=1e-4)
    opt = AdamW(parameters=tmodel.named_parameters(), learning_rate=1e-3,
                epsilon=1e-4)
    sf = to_static(tmodel)
    for ids in batches:
        j_loss, j_grads, j_stats = _jax_fused_loss_and_grads(jmodel, ids,
                                                             "O1")
        got = port_amp_loss_and_grads(tmodel, ids, forward=sf,
                                      keep_grads=True)
        assert_o1_close(got, (j_loss, j_grads))
        assert {k: sf.fusion_stats[k] for k in STAT_KEYS} == {
            k: j_stats[k] for k in STAT_KEYS}
        assert sf.fusion_stats["rewritten"] == {"rope_proj": 4,
                                                "residual_norm": 4}
        assert sf.fusion_stats["rejected"] == {"norm_linear": 1}
        for name, jp in jmodel.named_parameters():
            jp.grad = JTensor(jnp.asarray(j_grads[name]))
        opt.step()
        opt.clear_grad()
        j_opt.step()
        j_opt.clear_grad()


@pytest.mark.parametrize("family,cfg", [("llama", dict(LLAMA_TINY,
                                                        fused_loss=True)),
                                        ("gpt", GPT_TINY)])
def test_fused_recompute_matches_jax_fused_without_recompute(family, cfg,
                                                            fusion_on):
    """The JAX fused program with ``recompute=True`` raises; the port's
    fused program with recompute has the loss and gradients of the JAX
    fused program without it (fp32), and its pass ran inside the blocks."""
    jmodel, _ = _pair(family, cfg)
    _, tmodel = _pair(family, dict(cfg, recompute=True))
    ids = np.random.RandomState(12).randint(0, cfg["vocab_size"], (2, 16))
    sf = to_static(tmodel)
    loss, grads = port_amp_loss_and_grads(tmodel, ids, level="O0",
                                          forward=sf)
    j_loss, j_grads, _ = _jax_fused_loss_and_grads(jmodel, ids)
    np.testing.assert_allclose(loss, j_loss, atol=TOL, rtol=TOL)
    for key, want in j_grads.items():
        np.testing.assert_allclose(grads[key], want, atol=TOL, rtol=TOL,
                                   err_msg=key)
    want_rewrite = ({"rope_proj": 4, "residual_norm": 2} if family == "llama"
                    else {"norm_linear": 2, "residual_norm": 2,
                          "linear_act": 2})
    assert sf.fusion_stats["rewritten"] == want_rewrite


def test_flags():
    with pytest.raises(KeyError):
        set_flags({"FLAGS_no_such_flag": 1})
    set_flags({"enable_fusion": "1"})
    assert get_flag("enable_fusion") is True and fusion.enabled()
    set_flags({"FLAGS_enable_fusion": False})
    assert not fusion.enabled()
