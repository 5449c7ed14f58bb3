"""The rest of this slice against the JAX package: ``incubate.nn``'s
fused layers and MoE, ``nn.utils``, ``nn.lazy_init`` and ``nn.quant``;
the cases of ``tests/test_incubate_fused.py``, ``tests/test_nn.py`` and
``tests/test_nn_tail.py`` that exercise the ported names, run on both
packages; the public names of ``nn``, ``nn.functional`` and
``incubate.nn``, and the op registry's entries for the functionals.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.ops.registry import OPS as JAX_OPS
from paddle_tpu_torch.ops.registry import OPS as PORT_OPS
from torch_nn_parity import (_x, assert_layer_grads, layer_grads, pair,
                             port_layer_grads)
from torch_paddle_api import assert_same

PKGS = [pytest.param(jp, id="jax"), pytest.param(tp, id="port")]
RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _t(p, a):
    return p.to_tensor(np.asarray(a))


def _pair(build):
    return pair(build, seed=21)


# ---------------------------------------------------------- names, registry
# names that leak from a module's own imports, and faster_tokenizer's
LEAKED = {"annotations", "dtypes", "F"}
TOKENIZER = {"faster_tokenizer", "FasterTokenizer", "BertTokenizer",
             "load_vocab"}


@pytest.mark.parametrize("module", ["nn", "nn.functional", "incubate.nn"])
def test_no_public_name_is_missing(module):
    import importlib
    names = {n for n in dir(importlib.import_module(f"paddle_tpu.{module}"))
             if not n.startswith("_")}
    port = set(dir(importlib.import_module(f"paddle_tpu_torch.{module}")))
    assert sorted(names - port - LEAKED - TOKENIZER) == []


def test_every_functional_is_registered_as_in_the_jax_package():
    names = [n for n in dir(jp.nn.functional) if not n.startswith("_")
             and callable(getattr(jp.nn.functional, n))]
    bad = [(n, JAX_OPS[n].category, getattr(PORT_OPS.get(n), "category",
                                            None))
           for n in names if n in JAX_OPS
           and getattr(PORT_OPS.get(n), "category", None)
           != JAX_OPS[n].category]
    assert bad == []


# ------------------------------------------ test_incubate_fused.py's cases
def _xs(p, b=2, s=6, d=16, seed=0):
    return _t(p, np.random.RandomState(seed).randn(b, s, d).astype(
        np.float32))


@pytest.mark.parametrize("p", PKGS)
def test_fused_linear_and_dropout_add(p):
    for transpose in (False, True):
        fl = p.incubate.nn.FusedLinear(8, 4, transpose_weight=transpose)
        x = _t(p, np.random.RandomState(0).randn(3, 8).astype(np.float32))
        w = fl.weight.numpy()
        ref = x.numpy() @ (w.T if transpose else w) + fl.bias.numpy()
        np.testing.assert_allclose(fl(x).numpy(), ref, atol=1e-6)
    fda = p.incubate.nn.FusedDropoutAdd(p=0.5)
    fda.eval()
    a, b = _xs(p, seed=1), _xs(p, seed=2)
    np.testing.assert_allclose(fda(a, b).numpy(), (a + b).numpy(), atol=1e-6)


@pytest.mark.parametrize("p", PKGS)
def test_fused_mha_matches_manual(p):
    p.seed(0)
    mha = p.incubate.nn.FusedMultiHeadAttention(
        16, 4, dropout_rate=0.0, attn_dropout_rate=0.0)
    mha.eval()
    x = _xs(p, seed=5)
    qkv = p.reshape(mha.qkv(x), [2, 6, 3, 4, 4])
    q, k, v = p.unbind(qkv, axis=2)
    att = p.nn.functional.scaled_dot_product_attention(q, k, v)
    ref = mha.norm(x + mha.out_proj(p.reshape(att, [2, 6, 16])))
    np.testing.assert_allclose(mha(x).numpy(), ref.numpy(), atol=1e-4)
    with pytest.raises(NotImplementedError):
        p.incubate.nn.FusedMultiHeadAttention(16, 4, need_weights=True)
    with pytest.raises(NotImplementedError, match="cache"):
        p.incubate.nn.FusedTransformerEncoderLayer(16, 4, 32)(
            _xs(p), cache={})


FUSED = {
    "FusedBiasDropoutResidualLayerNorm": (
        lambda p: p.incubate.nn.FusedBiasDropoutResidualLayerNorm(
            16, dropout_rate=0.0), 2),
    "FusedMultiHeadAttention": (
        lambda p: p.incubate.nn.FusedMultiHeadAttention(
            16, 4, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=True), 1),
    "FusedFeedForward": (lambda p: p.incubate.nn.FusedFeedForward(
        16, 32, dropout_rate=0.0, activation="gelu"), 1),
    "FusedTransformerEncoderLayer": (
        lambda p: p.incubate.nn.FusedTransformerEncoderLayer(
            16, 4, 32, dropout_rate=0.0), 1),
}


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_layer_parity(name):
    """Outputs and parameter gradients, the JAX state carried over."""
    build, n_in = FUSED[name]
    jl, tl = _pair(build)
    xs = [np.random.RandomState(s).randn(2, 6, 16).astype(np.float32)
          for s in range(n_in)]
    j_out, j_grads = layer_grads(jl, lambda l, *ts: l(*ts), *xs)
    t_out, t_grads = port_layer_grads(tl, lambda l, *ts: l(*ts), *xs)
    assert_same(j_out, t_out, rtol=RTOL, atol=ATOL)
    assert_layer_grads(j_grads, t_grads,
                       [n for n, _ in tl.named_parameters()], GRAD_RTOL)


def test_moe_layer_parity():
    """The combined output and the load-balancing loss, and every
    parameter's gradient."""
    jl, tl = _pair(lambda p: p.incubate.nn.MoELayer(8, 4, d_hidden=16,
                                                    top_k=2))
    run = lambda layer, x: [layer(x), layer.l_aux]    # noqa: E731
    j_out, j_grads = layer_grads(jl, run, _x(30, 2, 5, 8))
    t_out, t_grads = port_layer_grads(tl, run, _x(30, 2, 5, 8))
    assert_same(j_out, t_out, rtol=RTOL, atol=ATOL)
    assert_layer_grads(j_grads, t_grads,
                       [n for n, _ in tl.named_parameters()], GRAD_RTOL)


# ------------------------------ test_nn.py / test_nn_tail.py on both packages
@pytest.mark.parametrize("p", PKGS)
def test_functional_mechanics(p):
    F = p.nn.functional
    x = np.arange(4, dtype="float32").reshape(1, 1, 2, 2)
    assert F.interpolate(_t(p, x), size=[4, 4]).shape == [1, 1, 4, 4]
    assert F.interpolate(_t(p, x), scale_factor=2,
                         mode="bilinear").shape == [1, 1, 4, 4]
    y = np.random.RandomState(1).randn(1, 1, 3, 3).astype("float32")
    out = F.pad(_t(p, y), [1, 1, 1, 1]).numpy()
    assert out.shape == (1, 1, 5, 5) and out[0, 0, 0, 0] == 0
    z = np.random.RandomState(2).randn(1, 8, 4, 4).astype("float32")
    np.testing.assert_array_equal(F.pixel_unshuffle(
        F.pixel_shuffle(_t(p, z), 2), 2).numpy(), z)
    lin = _t(p, np.linspace(-5, 5, 64, dtype="float32").reshape(8, 8))
    for fn in (F.mish, F.softplus, F.elu, F.selu, F.leaky_relu):
        assert np.isfinite(fn(lin).numpy()).all(), fn


@pytest.mark.parametrize("p", PKGS)
def test_layer_wrappers_and_inplace(p):
    rng = np.random.RandomState(7)
    x = _t(p, rng.randn(2, 3, 8).astype(np.float32))
    assert p.nn.Softmax2D()(x).shape == [2, 3, 8]
    assert p.nn.Unflatten(2, [2, 4])(x).shape == [2, 3, 2, 4]
    assert p.nn.ZeroPad1D([1, 2])(x).shape == [2, 3, 11]
    assert p.nn.SoftMarginLoss()(x, _t(p, np.sign(rng.randn(2, 3, 8))
                                       .astype(np.float32))).shape == []
    assert p.nn.LPPool1D(2, kernel_size=2, stride=2)(x).shape == [2, 3, 4]
    pooled, idx = p.nn.functional.max_pool1d(
        _t(p, rng.randn(1, 1, 8).astype(np.float32)), 2, stride=2,
        return_mask=True)
    assert p.nn.MaxUnPool1D(2, stride=2)(pooled, idx).shape == [1, 1, 8]
    r = _t(p, np.array([-2.0, 3.0], np.float32))
    assert p.nn.functional.relu_(r) is r
    np.testing.assert_allclose(r.numpy(), [0.0, 3.0])
    y = _t(p, np.array([0.5, -0.5], np.float32))
    y.stop_gradient = False
    z = y * 1.0
    p.nn.functional.tanh_(z)
    z.sum().backward()
    np.testing.assert_allclose(np.asarray(y.grad.numpy()),
                               1 - np.tanh([0.5, -0.5]) ** 2, rtol=1e-5)


# ------------------------------------------------ nn.utils, lazy_init, quant
def test_clip_grad_and_vectors():
    grads = {}
    for p in (jp, tp):
        params = [p.create_parameter([3, 2]), p.create_parameter([4])]
        for q, a in zip(params, (_x(40, 3, 2), _x(41, 4))):
            q.set_value(_t(p, a))
        loss = (params[0] * 3.0).sum() + (params[1] ** 2).sum()
        loss.backward()
        total = p.nn.utils.clip_grad_norm_(params, 1.5)
        p.nn.utils.clip_grad_value_(params, 0.2)
        vec = p.nn.utils.parameters_to_vector(params)
        p.nn.utils.vector_to_parameters(vec * 2.0, params)
        grads[p] = [float(total.numpy())] + [np.asarray(q.grad.numpy())
                                             for q in params] + [
            np.asarray(q.numpy()) for q in params]
    for j, t in zip(grads[jp], grads[tp]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_weight_norm_roundtrip():
    outs = []
    for p, lin in zip((jp, tp), _pair(lambda p: p.nn.Linear(4, 3))):
        w0 = np.asarray(lin.weight.numpy())
        p.nn.utils.weight_norm(lin, dim=1)
        names = sorted(n for n, _ in lin.named_parameters())
        assert names == ["bias", "weight_g", "weight_v"]
        x = _t(p, _x(42, 2, 4))
        out = lin(x)
        p.nn.utils.remove_weight_norm(lin)
        np.testing.assert_allclose(np.asarray(lin.weight.numpy()), w0,
                                   rtol=1e-5)
        outs.append(np.asarray(out.numpy()))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_lazy_guard_defers_until_the_first_call():
    from paddle_tpu_torch.nn.lazy_init import LazyGuard, materialize_layer
    with LazyGuard():
        lin = tp.nn.Linear(4, 3)
        assert lin.weight._data.is_meta and lin.weight.shape == [4, 3]
    out = lin(tp.to_tensor(_x(43, 2, 4)))
    assert not lin.weight._data.is_meta and out.shape == [2, 3]
    assert not lin.weight.stop_gradient
    with LazyGuard():
        other = tp.nn.Linear(2, 2)
    assert materialize_layer(other) == 2 and materialize_layer(other) == 0


def test_nn_quant_is_the_quantization_module():
    from paddle_tpu_torch import quantization
    for name in tp.nn.quant.__all__:
        assert getattr(tp.nn.quant, name) is getattr(quantization, name)
