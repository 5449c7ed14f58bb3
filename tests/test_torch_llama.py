"""The port's LLaMA against the JAX package's, weights carried over.

A tiny JAX LLaMA (hidden 128, heads of 64, intermediate 256, 2 layers)
gets numpy-seeded weights; ``load_jax_state`` copies them into the port's
model (Linear weights transposed). Logits and loss must agree in fp32,
with MHA and GQA; ``rope_rotate`` with an int and a per-batch
offset; and two AdamW steps of the fused programs (``to_static`` with
``FLAGS_enable_fusion``; the JAX side under ``jax.value_and_grad`` with its
Pallas kernels interpreted) must land on the same losses and weights.
With ``recompute`` and ``fused_loss`` under amp O1 bf16 (tied and untied
heads), the loss and gradients are held to the JAX model's under the same
``auto_cast`` (``test_torch_gpt``'s O1 tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import fused_ops as JK
from paddle_tpu_torch import set_flags, to_static
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama2_70b, llama_7b, llama_tiny,
                                     load_jax_state, rope_rotate)
from paddle_tpu_torch.optimizer import AdamW
from test_torch_gpt import (assert_o1_close, jax_amp_loss_and_grads,
                            port_amp_loss_and_grads)

TOL = 1e-4
STEP_TOL = 1e-5
TINY = dict(vocab_size=96, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=2, max_seq_len=64)
GQA = dict(TINY, num_heads=4, num_kv_heads=2)
# The two packages' gradients agree to about 1e-7 absolute (fp32 sums in
# another order). Adam divides by sqrt(v) + epsilon, so for a gradient
# element far below epsilon that difference moves a weight by about
# lr * 1e-7 / epsilon: 1e-4 bounds it at 1e-6 (at 1e-6, a 2e-7 gradient
# became a 2e-5 weight difference). See also tests/test_torch_train.py.
ADAMW = dict(learning_rate=1e-3, beta1=0.9, beta2=0.95, epsilon=1e-4,
             weight_decay=0.1)


def seeded_state(model, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for key, p in model.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("layernorm.weight") or key == "model.norm.weight":
            arr = 1.0 + 0.1 * rng.randn(*shape)
        elif key.endswith("embed_tokens.weight"):
            arr = 0.5 * rng.randn(*shape)
        else:
            arr = rng.randn(*shape) / np.sqrt(shape[0])
        out[key] = arr.astype(np.float32)
    return out


def tiny_pair(cfg=TINY, seed=0):
    jmodel = JaxLlama(JaxLlamaConfig(**cfg))
    state = seeded_state(jmodel, seed)
    jmodel.set_state_dict(state)
    tmodel = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    load_jax_state(tmodel, state)
    return jmodel, tmodel


def _ids(b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], (b, s))


@pytest.mark.parametrize("cfg,use_flash", [(TINY, True), (GQA, False)],
                         ids=["mha-flash", "gqa-plain-attention"])
def test_logits_and_loss_match_jax(cfg, use_flash):
    cfg = dict(cfg, use_flash_attention=use_flash)
    jmodel, tmodel = tiny_pair(cfg)
    ids = _ids()
    j_logits, j_loss = jmodel(paddle.to_tensor(ids),
                              labels=paddle.to_tensor(ids))
    with torch.no_grad():
        logits, loss = tmodel(torch.from_numpy(ids),
                              labels=torch.from_numpy(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits.numpy()),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("offset", [0, 5, "per_batch"])
def test_rope_rotate_matches_jax(offset):
    a = np.random.RandomState(2).randn(3, 12, 2, 64).astype(np.float32)
    off = np.array([0, 7, 300], np.int32) if offset == "per_batch" else offset
    want = jllama.rope_rotate(jnp.asarray(a), 10000.0,
                              jnp.asarray(off) if offset == "per_batch"
                              else off)
    got = rope_rotate(torch.from_numpy(a), 10000.0,
                      torch.from_numpy(off) if offset == "per_batch" else off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _jax_fused_steps(jmodel, batches):
    """bench.py's fusion-rung pattern: to_static under value_and_grad with
    the parameters rebound to the traced arrays, then the JAX AdamW."""
    paddle.jit.to_static(jmodel, full_graph=True)
    params = list(jmodel.parameters())

    def loss_of(arrays, ids):
        originals = [p._data for p in params]
        for p, a in zip(params, arrays):
            p._data = a
        try:
            _, loss = jmodel(Tensor(ids), labels=Tensor(ids))
            return loss._data
        finally:
            for p, o in zip(params, originals):
                p._data = o

    step = jax.value_and_grad(loss_of)
    opt = jopt.AdamW(parameters=params, **ADAMW)
    losses = []
    for ids in batches:
        loss, grads = step([p._data for p in params], jnp.asarray(ids))
        for p, g in zip(params, grads):
            p.grad = Tensor(g)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def test_two_fused_adamw_steps_match_jax():
    jmodel, tmodel = tiny_pair(seed=4)
    batches = [_ids(seed=20), _ids(seed=21)]
    old = JK.INTERPRET
    JK.INTERPRET = True
    paddle.set_flags({"FLAGS_enable_fusion": True})
    set_flags({"FLAGS_enable_fusion": True})
    try:
        want = _jax_fused_steps(jmodel, batches)
        sf = to_static(tmodel)
        opt = AdamW(parameters=tmodel.named_parameters(), **ADAMW)
        losses = []
        for ids in batches:
            t = torch.from_numpy(ids)
            _, loss = sf(t, labels=t)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
    finally:
        JK.INTERPRET = old
        paddle.set_flags({"FLAGS_enable_fusion": False})
        set_flags({"FLAGS_enable_fusion": False})
    assert sf.fusion_stats["rewritten"] == {"rope_proj": 4,
                                            "residual_norm": 4}
    np.testing.assert_allclose(losses, want, atol=STEP_TOL, rtol=STEP_TOL)
    linear = {f"{n}.weight" for n, m in tmodel.named_modules()
              if isinstance(m, torch.nn.Linear)}
    t_state = tmodel.state_dict()
    for key, value in jmodel.state_dict().items():
        got = t_state[key].numpy()
        np.testing.assert_allclose(got.T if key in linear else got,
                                   np.asarray(value.numpy()), atol=STEP_TOL,
                                   rtol=STEP_TOL, err_msg=key)


def test_configs_params_and_later_slices():
    jmodel, tmodel = tiny_pair(GQA)
    assert set(tmodel.state_dict()) == set(jmodel.state_dict())
    assert tmodel.num_params() == jmodel.num_params()
    assert tmodel.flops_per_token() == 6 * tmodel.num_params() + 12 * 2 * 128 * 64
    assert (llama_7b().hidden_size, llama_7b().num_layers) == (4096, 32)
    assert llama2_70b().num_kv_heads == 8
    assert llama_tiny().num_kv_heads == llama_tiny().num_heads == 4
    with pytest.raises(ValueError):
        LlamaConfig(num_heads=4, num_kv_heads=3)
    for kw in (dict(mp_degree=2), dict(sequence_parallel=True),
               dict(context_parallel="ring")):
        with pytest.raises(NotImplementedError, match="later slice"):
            LlamaConfig(**kw)
    cfg = LlamaConfig(recompute=True, fused_loss=True)
    assert cfg.recompute and cfg.fused_loss


@pytest.mark.parametrize("tie", [False, True], ids=["lm_head", "tied"])
@pytest.mark.parametrize("recompute,fused_loss", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_o1_recompute_fused_loss_matches_jax(recompute, fused_loss, tie):
    cfg = dict(GQA, recompute=recompute, fused_loss=fused_loss,
               tie_embeddings=tie)
    jmodel, tmodel = tiny_pair(cfg, seed=3)
    ids = _ids(seed=8)
    assert_o1_close(port_amp_loss_and_grads(tmodel, ids),
                    jax_amp_loss_and_grads(jmodel, ids))
