"""The port's GPT training path against the JAX package's.

A tiny GPT with numpy-seeded weights (``test_torch_gpt.seeded_state``)
is copied into the port with ``load_jax_state``. The loss and every
parameter's gradient must match the JAX model's ``loss.backward()``
(Linear weights transposed), with either attention route; then both
packages run the same 3-step eager loop (``model(ids, labels=ids)``,
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``) with AdamW,
global-norm clipping and a warm-up/cosine schedule. On CPU tensors the
port's attention is the autograd Function over the flash kernels' plain
versions. Dropout draws from the model's own generator.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.nn import ClipGradByGlobalNorm as JClipGlobal
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import dropout
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.optimizer import (AdamW, CosineAnnealingDecay,
                                        LinearWarmup)
from test_torch_gpt import TINY, tiny_pair

TOL = 1e-4
# The key third of qkv_proj.bias has a gradient of exactly 0 in exact
# arithmetic (softmax ignores a shift shared by a row's logits), so each
# package holds rounding noise of about 1e-9 there, of either sign. With
# Adam's usual epsilon of 1e-8 that noise becomes a step of about a tenth
# of the learning rate in a direction that differs between the packages;
# an epsilon of 1e-6 keeps such steps below 1e-3 of it.
EPS = 1e-6


def _ids(b=2, s=24, seed=0):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], (b, s))


def _grad_of(tmodel, key):
    """The port's gradient of state-dict entry ``key`` in the JAX layout."""
    g = tmodel.get_parameter(key).grad.detach().numpy()
    linear = {f"{n}.weight" for n, m in tmodel.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return g.T if key in linear else g


@pytest.mark.parametrize("use_flash", [True, False])
def test_loss_and_grads_match_jax(use_flash):
    jmodel, tmodel, _ = tiny_pair(use_flash)
    ids = _ids()
    _, j_loss = jmodel(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    j_loss.backward()
    j_grads = {n: np.asarray(p.grad.numpy())
               for n, p in jmodel.named_parameters()}

    t_ids = torch.from_numpy(ids)
    logits, loss = tmodel(t_ids, labels=t_ids)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), atol=TOL,
                               rtol=TOL)
    with torch.no_grad():
        torch.testing.assert_close(tmodel(t_ids), logits.detach(), atol=0,
                                   rtol=0)
    assert set(j_grads) == {n for n, _ in tmodel.named_parameters()}
    for key, want in j_grads.items():
        np.testing.assert_allclose(_grad_of(tmodel, key), want, atol=TOL,
                                   rtol=TOL, err_msg=key)


def _jax_loop(jmodel, batches, decays):
    sched = jopt.lr.LinearWarmup(
        jopt.lr.CosineAnnealingDecay(1e-3, T_max=10), warmup_steps=2,
        start_lr=1e-4, end_lr=1e-3)
    # JAX parameter names are global counters: map them to the dotted
    # state-dict keys the port's apply_decay_param_fun sees
    dotted = {p.name: n for n, p in jmodel.named_parameters()}
    opt = jopt.AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                     epsilon=EPS, weight_decay=0.1,
                     parameters=jmodel.parameters(),
                     apply_decay_param_fun=lambda name: decays(dotted[name]),
                     grad_clip=JClipGlobal(1.0))
    losses = []
    for ids in batches:
        t = paddle.to_tensor(ids)
        _, loss = jmodel(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
    return losses


def _port_loop(tmodel, batches, decays):
    sched = LinearWarmup(CosineAnnealingDecay(1e-3, T_max=10),
                         warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=EPS,
                weight_decay=0.1, parameters=tmodel.named_parameters(),
                apply_decay_param_fun=decays,
                grad_clip=ClipGradByGlobalNorm(1.0))
    losses = []
    for ids in batches:
        t = torch.from_numpy(ids)
        _, loss = tmodel(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.detach()))
    return losses


def test_three_eager_steps_match_jax():
    jmodel, tmodel, _ = tiny_pair(use_flash=True, seed=1)
    jmodel.train()
    tmodel.train()
    batches = [_ids(seed=10 + i) for i in range(3)]

    def decays(name):
        return not name.endswith(("bias", "ln1.weight", "ln2.weight",
                                  "ln_f.weight"))

    j_losses = _jax_loop(jmodel, batches, decays)
    launches = fa.flash_attention_fwd.launches
    losses = _port_loop(tmodel, batches, decays)
    assert fa.flash_attention_fwd.launches == launches     # a CPU run
    np.testing.assert_allclose(losses, j_losses, atol=TOL, rtol=TOL)
    assert losses[-1] < losses[0]
    j_state = jmodel.state_dict()
    t_state = tmodel.state_dict()
    for key, value in j_state.items():
        np.testing.assert_allclose(
            _layout(tmodel, key, t_state[key].numpy()),
            np.asarray(value.numpy()), atol=TOL, rtol=TOL, err_msg=key)


def _layout(tmodel, key, arr):
    linear = {f"{n}.weight" for n, m in tmodel.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return arr.T if key in linear else arr


def test_num_params_and_flops_match_jax():
    jmodel, tmodel, _ = tiny_pair()
    assert tmodel.num_params() == jmodel.num_params()
    assert tmodel.flops_per_token() == jmodel.flops_per_token()


DROPOUT = GPTConfig(dropout=0.2, **TINY)


def test_dropout_uses_the_model_generator_only():
    """Two models built with the same seed drop the same elements; another
    seed drops others; torch's global RNG is untouched by a training
    forward."""
    ids = torch.from_numpy(_ids(b=2, s=16, seed=3))
    a = GPTForCausalLM(DROPOUT, device="cpu", seed=5).train()
    b = GPTForCausalLM(DROPOUT, device="cpu", seed=5).train()
    c = GPTForCausalLM(DROPOUT, device="cpu", seed=6).train()
    c.load_state_dict(a.state_dict())
    assert a.gpt.generator is a.gpt.blocks[0].generator
    assert a.gpt.blocks[1].attn.generator is a.gpt.generator
    state = torch.get_rng_state()
    out_a, out_b, out_c = (m(ids) for m in (a, b, c))
    assert torch.equal(torch.get_rng_state(), state)
    torch.testing.assert_close(out_a, out_b, atol=0, rtol=0)
    assert not torch.equal(out_a, out_c)
    with torch.no_grad():                   # eval mode drops nothing
        torch.testing.assert_close(a.eval()(ids), c.eval()(ids), atol=0,
                                   rtol=0)


def test_dropout_functional():
    x = torch.ones((64, 256))
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, p=0.25, generator=gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    rows = dropout(x, p=0.5, axis=0, generator=gen)   # one draw per row
    assert torch.equal(rows.amin(dim=1), rows.amax(dim=1))
    assert torch.equal(dropout(x, p=0.3, training=False), x)
    torch.testing.assert_close(
        dropout(x, p=0.3, training=False, mode="downscale_in_infer"), 0.7 * x)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, p=0.1)
