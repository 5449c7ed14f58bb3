"""The port's GPT forward against the JAX package's, weights carried over.

A tiny JAX GPT gets numpy-seeded weights (wider than GPT-2's init, so the
logits are far from uniform); ``load_jax_state`` copies them into the
port's model, and the fp32 logits must agree. On CPU tensors the port's
attention runs the flash kernel's plain version. With ``recompute`` and
``fused_loss`` under amp O1 bf16, the port's loss and gradients are held
to ``jax.value_and_grad`` of the JAX model under the same ``auto_cast``
(as ``bench.py``'s rungs run it): the loss within O1_LOSS_RTOL, each
gradient within O1_GRAD_RTOL norm-wise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, gpt2_medium,
                                     gpt2_small, load_jax_state)

ATOL = RTOL = 1e-4
# amp O1 bf16: both packages round the same products to bf16, in sums of
# another order
O1_LOSS_RTOL = 5e-3
O1_GRAD_RTOL = 2e-2
TINY = dict(vocab_size=83, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64)


def seeded_state(model, seed=0):
    """numpy weights for every entry of a JAX model's state dict."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, p in model.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            arr = 1.0 + 0.1 * rng.randn(*shape)
        elif key.endswith("bias"):
            arr = 0.1 * rng.randn(*shape)
        elif key.endswith(("wte.weight", "wpe.weight")):
            arr = 0.5 * rng.randn(*shape)
        else:
            arr = rng.randn(*shape) / np.sqrt(shape[0])
        out[key] = arr.astype(np.float32)
    return out


def tiny_pair(use_flash=True, seed=0):
    jmodel = JaxGPT(JaxGPTConfig(use_flash_attention=use_flash, **TINY))
    jmodel.eval()
    state = seeded_state(jmodel, seed)
    jmodel.set_state_dict(state)
    tmodel = GPTForCausalLM(GPTConfig(use_flash_attention=use_flash, **TINY),
                            device="cpu").eval()
    load_jax_state(tmodel, state)
    return jmodel, tmodel, state


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("b,s", [(1, 1), (2, 17), (2, 64)])
def test_logits_match_jax(b, s, use_flash):
    jmodel, tmodel, _ = tiny_pair(use_flash)
    ids = np.random.RandomState(s).randint(0, TINY["vocab_size"], (b, s))
    ref = np.asarray(jmodel(paddle.to_tensor(ids.astype(np.int64))).numpy())
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_state_dict_keys_line_up():
    jmodel, tmodel, state = tiny_pair()
    assert set(tmodel.state_dict()) == set(state)
    w = state["gpt.blocks.0.attn.qkv_proj.weight"]            # (in, out)
    np.testing.assert_array_equal(
        tmodel.gpt.blocks[0].attn.qkv_proj.weight.detach().numpy(), w.T)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_load_jax_state_rejects_mismatch(fault):
    _, tmodel, state = tiny_pair()
    state = dict(state)
    if fault == "missing":
        del state["gpt.ln_f.bias"]
        err = KeyError
    elif fault == "unexpected":
        state["gpt.lm_head.weight"] = np.zeros((83, 64), np.float32)
        err = KeyError
    else:
        state["gpt.wpe.weight"] = np.zeros((32, 64), np.float32)
        err = ValueError
    with pytest.raises(err):
        load_jax_state(tmodel, state)


def test_configs_and_later_slices():
    assert (gpt2_small().hidden_size, gpt2_small().num_layers) == (768, 12)
    assert gpt2_small().vocab_size == 50304
    assert gpt2_small().intermediate_size == 3072
    m = gpt2_medium()
    assert (m.hidden_size, m.num_layers, m.num_heads) == (1024, 24, 16)
    for kw in (dict(sequence_parallel=True), dict(context_parallel="ring"),
               dict(mp_degree=2, fused_loss=True)):
        with pytest.raises(NotImplementedError, match="later slice"):
            GPTConfig(**kw)
    cfg = GPTConfig(recompute=True, fused_loss=True)
    assert cfg.recompute and cfg.fused_loss
    # tensor parallel since the distributed slice: the config builds, the
    # model needs fleet's mp group of that size
    tp = GPTConfig(mp_degree=2, **TINY)
    assert tp.mp_degree == 2
    with pytest.raises(RuntimeError, match="fleet.init"):
        GPTForCausalLM(tp, device="cpu")


def test_seeded_init_is_reproducible():
    cfg = GPTConfig(**TINY)
    a = GPTForCausalLM(cfg, device="cpu", seed=3)
    b = GPTForCausalLM(cfg, device="cpu", seed=3)
    c = GPTForCausalLM(cfg, device="cpu", seed=4)
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
        if k.endswith("qkv_proj.weight"):
            assert not torch.equal(x, z)
    std = a.gpt.blocks[0].mlp.fc1.weight.std().item()
    assert 0.015 < std < 0.025


def jax_amp_loss_and_grads(jmodel, ids, level="O1", dtype="bfloat16"):
    """``bench.py``'s step: ``jax.value_and_grad`` of the JAX model's loss
    with the parameters rebound to the traced arrays, under
    ``auto_cast``. Returns the loss and the gradients by parameter name."""
    named = [(n, p) for n, p in jmodel.named_parameters()
             if not p.stop_gradient]
    params = [p for _, p in named]

    def loss_of(arrays):
        originals = [p._data for p in params]
        for p, a in zip(params, arrays):
            p._data = a
        try:
            with jamp.auto_cast(level=level, dtype=dtype):
                _, loss = jmodel(JTensor(ids), labels=JTensor(ids))
            return loss._data.astype(jnp.float32)
        finally:
            for p, o in zip(params, originals):
                p._data = o

    loss, grads = jax.value_and_grad(loss_of)([p._data for p in params])
    return float(loss), {n: np.asarray(g.astype(jnp.float32))
                         for (n, _), g in zip(named, grads)}


def port_amp_loss_and_grads(tmodel, ids, level="O1", dtype="bfloat16",
                            forward=None, keep_grads=False):
    """The port's loss under ``auto_cast`` and its gradients by parameter
    name, in the JAX layout (Linear weights transposed); the ``.grad``s are
    cleared unless ``keep_grads``."""
    t = torch.from_numpy(ids)
    with amp.auto_cast(level=level, dtype=dtype):
        _, loss = (forward or tmodel)(t, labels=t)
    loss.backward()
    linear = {f"{n}.weight" for n, m in tmodel.named_modules()
              if isinstance(m, torch.nn.Linear)}
    grads = {}
    for n, p in tmodel.named_parameters():
        g = p.grad.float().numpy()
        grads[n] = g.T if n in linear else g
    if not keep_grads:
        tmodel.zero_grad()
    return float(loss.detach()), grads


def assert_o1_close(got, want):
    (loss, grads), (j_loss, j_grads) = got, want
    assert abs(loss - j_loss) <= O1_LOSS_RTOL * abs(j_loss), (loss, j_loss)
    assert set(grads) == set(j_grads)
    for key, g in j_grads.items():
        rel = np.linalg.norm(grads[key] - g) / np.linalg.norm(g)
        assert rel <= O1_GRAD_RTOL, (key, rel)


@pytest.mark.parametrize("recompute,fused_loss", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_o1_recompute_fused_loss_matches_jax(recompute, fused_loss):
    cfg = dict(TINY, recompute=recompute, fused_loss=fused_loss)
    jmodel = JaxGPT(JaxGPTConfig(**cfg))
    state = seeded_state(jmodel, seed=2)
    jmodel.set_state_dict(state)
    tmodel = GPTForCausalLM(GPTConfig(**cfg), device="cpu").train()
    load_jax_state(tmodel, state)
    ids = np.random.RandomState(9).randint(0, TINY["vocab_size"], (2, 24))
    assert_o1_close(port_amp_loss_and_grads(tmodel, ids),
                    jax_amp_loss_and_grads(jmodel, ids))
