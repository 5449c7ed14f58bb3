"""The port's recompute (``distributed.fleet.recompute``, the models'
``recompute``) against the same program without it.

Recompute does not change the function: on fp32 CPU tensors the loss and
every gradient with ``recompute=True`` equal those without it within
1e-6, for GPT-2 and LLaMA, eager and through ``to_static``. With dropout
0.1 the replay draws the forward's masks again from the model's own
generator, and after the backward the generator stands where it stands
without recompute. ``recompute_sequential`` checkpoints chunks of a layer
list the same way. The JAX package's ``recompute`` on the same weights
gives the same gradients (its eager PyLayer path).
"""
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import recompute as j_recompute
from paddle_tpu_torch import to_static
from paddle_tpu_torch.core import get_rng_state, make_generator, set_rng_state
from paddle_tpu_torch.distributed.fleet import recompute, recompute_sequential
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.nn import functional as F

TOL = 1e-6
GPT_TINY = dict(vocab_size=96, hidden_size=64, num_layers=3, num_heads=2,
                max_seq_len=32)
LLAMA_TINY = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
                  num_layers=3, num_heads=2, num_kv_heads=1, max_seq_len=32)


def _model(family, recompute_on, dropout=0.0, fused_loss=False):
    if family == "gpt":
        cfg = GPTConfig(**GPT_TINY, dropout=dropout, recompute=recompute_on,
                        fused_loss=fused_loss)
        return GPTForCausalLM(cfg, device="cpu", seed=3).train()
    cfg = LlamaConfig(**LLAMA_TINY, recompute=recompute_on,
                      fused_loss=fused_loss)
    return LlamaForCausalLM(cfg, device="cpu", seed=3).train()


def _generator(model):
    return model.gpt.generator if hasattr(model, "gpt") else None


def _loss_and_grads(model, ids, static=False):
    forward = to_static(model) if static else model
    gen = _generator(model)
    start = None if gen is None else gen.get_state()
    if static:            # the trace draws once; start the step afresh
        with torch.no_grad():
            forward(ids, labels=ids)
        if gen is not None:
            gen.set_state(start)
    _, loss = forward(ids, labels=ids)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    return float(loss.detach()), grads, (None if gen is None
                                         else gen.get_state())


@pytest.mark.parametrize("family,dropout", [("gpt", 0.0), ("gpt", 0.1),
                                            ("llama", 0.0)])
@pytest.mark.parametrize("fused_loss", [False, True])
@pytest.mark.parametrize("static", [False, True], ids=["eager", "to_static"])
def test_recompute_keeps_loss_grads_and_generator(family, dropout,
                                                  fused_loss, static):
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 96, (2, 24)))
    plain = _model(family, False, dropout, fused_loss)
    remat = _model(family, True, dropout, fused_loss)
    remat.load_state_dict(plain.state_dict())
    want_loss, want, want_gen = _loss_and_grads(plain, ids)
    loss, got, gen = _loss_and_grads(remat, ids, static)
    assert loss == pytest.approx(want_loss, rel=TOL, abs=TOL)
    assert set(got) == set(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name], atol=TOL, rtol=TOL,
                                   msg=name)
    if want_gen is not None:
        assert torch.equal(gen, want_gen)


def _saved_bytes(fn):
    """Bytes of the tensors autograd saves for the backward while ``fn``
    runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("static", [False, True], ids=["eager", "to_static"])
def test_recompute_keeps_only_block_inputs(static):
    """The checkpoint holds: eager and traced, a recomputed forward saves
    far less for the backward than the plain one."""
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 96, (2, 24)))
    saved = {}
    for on in (False, True):
        model = _model("llama", on)
        forward = to_static(model) if static else model
        saved[on] = _saved_bytes(lambda: forward(ids, labels=ids))
    assert saved[True] < 0.5 * saved[False]


def test_without_preserved_rng_the_masks_differ():
    """What the generator snapshot is for: without it the replay draws new
    dropout masks, and the gradients are not those of the forward."""
    gen = make_generator(5)
    lin = nn.Linear(16, 16)
    x = torch.randn(4, 16)

    def block(a):
        return F.dropout(lin(a), p=0.5, generator=gen).sum(dim=-1)

    grads = {}
    for mode in ("plain", "preserve", "no_preserve"):
        gen.manual_seed(5)
        lin.zero_grad()
        if mode == "plain":
            out = block(x)
        else:
            out = recompute(block, x, preserve_rng_state=mode == "preserve",
                            generators=[gen])
        out.sum().backward()
        grads[mode] = lin.weight.grad.clone()
    torch.testing.assert_close(grads["preserve"], grads["plain"], atol=0,
                               rtol=0)
    assert not torch.equal(grads["no_preserve"], grads["plain"])


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_matches_plain(segments):
    torch.manual_seed(0)
    layers = nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 16),
                           nn.Tanh(), nn.Linear(16, 4))
    x = torch.randn(5, 8, requires_grad=True)
    layers(x).square().sum().backward()
    want = [p.grad.clone() for p in layers.parameters()] + [x.grad.clone()]
    layers.zero_grad()
    x.grad = None
    out = recompute_sequential({"segments": segments}, layers, x)
    out.square().sum().backward()
    got = [p.grad for p in layers.parameters()] + [x.grad]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError):
        recompute_sequential({}, [], x)


def test_rng_state_snapshot_and_restore():
    gens = [make_generator(1), make_generator(2)]
    snap = get_rng_state(gens)
    first = [torch.rand(3, generator=g) for g in gens]
    set_rng_state(gens, snap)
    again = [torch.rand(3, generator=g) for g in gens]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        set_rng_state(gens, snap[:1])


def test_recompute_matches_jax_recompute():
    """The JAX package's eager ``recompute`` of one linear + gelu block and
    the port's give the same gradients."""
    rng = np.random.RandomState(4)
    x, w, b = (rng.randn(*s).astype(np.float32)
               for s in ((3, 8), (8, 6), (6,)))
    jl = paddle.nn.Linear(8, 6)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    jx = paddle.to_tensor(x, stop_gradient=False)
    j_out = j_recompute(lambda a: paddle.nn.functional.gelu(jl(a)), jx,
                        params=[jl.weight, jl.bias])
    paddle.sum(j_out * j_out).backward()
    tl = nn.Linear(8, 6)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
        tl.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x).requires_grad_()
    t_out = recompute(lambda a: F.gelu(F.linear(a, tl.weight, tl.bias)), tx)
    (t_out * t_out).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.weight.grad.numpy().T,
                               np.asarray(jl.weight.grad.numpy()), atol=1e-5,
                               rtol=1e-5)
