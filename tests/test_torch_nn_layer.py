"""The port's ``nn.Layer`` and its layers against the JAX package's.

``tests/test_nn.py::TestLayerMechanics``'s cases on both packages; then
``Linear``, ``Embedding``, ``LayerNorm``, ``Dropout``,
``MultiHeadAttention`` and ``TransformerEncoder`` built in both, the JAX
layer's numpy state carried into the port's with ``set_state_dict``
(``load_jax_layer_state``), outputs and parameter gradients held to
RTOL/ATOL and GRAD_RTOL on the same numpy-seeded inputs.
"""
import copy

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state
from torch_paddle_api import assert_grads, assert_same

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL = 1e-4        # norm-wise, each parameter
PKGS = [pytest.param(jp, id="jax"), pytest.param(tp, id="port")]


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _carry(jlayer, tlayer):
    """The JAX layer's state into the port's; returns the port layer."""
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    return load_jax_layer_state(tlayer, state)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ----------------------------------------- test_nn.py::TestLayerMechanics
@pytest.mark.parametrize("p", PKGS)
def test_parameter_registration(p):
    l = p.nn.Linear(4, 3)
    assert [n for n, _ in l.named_parameters()] == ["weight", "bias"]
    assert l.weight.shape == [4, 3]


@pytest.mark.parametrize("p", PKGS)
def test_sublayer_nesting(p):
    class Net(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = p.nn.Linear(4, 8)
            self.fc2 = p.nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(p.nn.functional.relu(self.fc1(x)))

    net = Net()
    assert {n for n, _ in net.named_parameters()} == {
        "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    assert len(net.sublayers()) == 2


@pytest.mark.parametrize("p", PKGS)
def test_state_dict_roundtrip(p):
    nn = p.nn
    net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    net2 = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    assert net2.set_state_dict(net.state_dict()) == ([], [])
    np.testing.assert_array_equal(net[0].weight.numpy(),
                                  net2[0].weight.numpy())


@pytest.mark.parametrize("p", PKGS)
def test_buffers_in_state_dict(p):
    sd = p.nn.BatchNorm2D(4).state_dict()
    assert "_mean" in sd and "_variance" in sd


@pytest.mark.parametrize("p", PKGS)
def test_train_eval_mode(p):
    net = p.nn.Sequential(p.nn.Linear(2, 2), p.nn.Dropout(0.5))
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training


@pytest.mark.parametrize("p", PKGS)
def test_forward_hooks(p):
    l = p.nn.Linear(2, 2)
    calls = []
    h1 = l.register_forward_pre_hook(lambda layer, inp: calls.append("pre"))
    h2 = l.register_forward_post_hook(
        lambda layer, inp, out: calls.append("post"))
    l(p.to_tensor(np.ones((1, 2), "float32")))
    assert calls == ["pre", "post"]
    h1.remove()
    h2.remove()
    calls.clear()
    l(p.to_tensor(np.ones((1, 2), "float32")))
    assert calls == []


@pytest.mark.parametrize("p", PKGS)
def test_to_dtype(p):
    l = p.nn.Linear(2, 2)
    l.to(dtype="bfloat16")
    assert l.weight.dtype == p.bfloat16


# ------------------------------------------------ layers on carried weights
def _loss(p, out):
    """A fixed random projection of ``out``: sum(out^2) would be constant
    after a LayerNorm and leave only rounding noise as gradients."""
    w = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    return (out * p.to_tensor(w)).sum()


def _run_layer(build, inputs, backward=True):
    """Build the layer in both packages, carry the weights, run both on
    ``inputs`` (numpy) and compare outputs and parameter gradients."""
    jl, tl = build(jp), build(tp)
    _carry(jl, tl)
    outs = []
    for p, l in ((jp, jl), (tp, tl)):
        xs = [p.to_tensor(x) for x in inputs]
        out = l(*xs)
        if backward:
            _loss(p, out).backward()
        outs.append(out)
    assert_same(*outs, RTOL, ATOL)
    if backward:
        assert_grads(jl, tl, GRAD_RTOL)
    return jl, tl


# the shapes are test_torch_bert's tiny encoder's (B2 S16, hidden 32): the
# JAX package compiles each eager op once a process and shape
def test_linear_on_carried_weights():
    _run_layer(lambda p: p.nn.Linear(32, 64), [_x(0, (2, 16, 32))])


def test_embedding_on_carried_weights():
    ids = np.random.RandomState(1).randint(0, 64, (2, 16))
    ids[0, :3] = 7
    _, tl = _run_layer(lambda p: p.nn.Embedding(64, 32, padding_idx=7),
                       [ids])
    np.testing.assert_array_equal(tl.weight.grad.numpy()[7], 0.0)


def test_layer_norm_on_carried_weights():
    def build(p):
        ln = p.nn.LayerNorm(32, epsilon=1e-6)
        ln.weight.set_value(_x(1, (32,)))
        ln.bias.set_value(_x(2, (32,)))
        return ln
    _run_layer(build, [_x(0, (2, 16, 32)) * 3 + 1])


@pytest.mark.parametrize("training", [False, True])
def test_dropout(training):
    x = np.ones((64, 64), np.float32)
    for p in (jp, tp):
        d = p.nn.Dropout(0.25)
        d.train() if training else d.eval()
        y = d(p.to_tensor(x)).numpy()
        if not training:
            np.testing.assert_array_equal(y, x)
        else:        # kept entries scaled by 1/(1-p); about p dropped
            kept = y != 0
            np.testing.assert_allclose(y[kept], 1 / 0.75, rtol=1e-6)
            assert 0.2 < 1 - kept.mean() < 0.3


def test_dropout_draws_from_the_paddle_generator():
    import torch
    state = torch.get_rng_state()
    tp.seed(7)
    a = tp.nn.Dropout(0.5)(tp.ones([32])).numpy()
    tp.seed(7)
    b = tp.nn.Dropout(0.5)(tp.ones([32])).numpy()
    np.testing.assert_array_equal(a, b)
    assert torch.equal(torch.get_rng_state(), state)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_on_carried_weights(masked):
    x = _x(0, (2, 16, 32))
    mask = (np.arange(16)[None, None, None, :] < np.array(
        [16, 9])[:, None, None, None])      # (2, 1, 1, 16) bool, True keeps

    def build(p):
        return p.nn.MultiHeadAttention(32, 4)
    jl, tl = build(jp), build(tp)
    _carry(jl, tl)
    outs = []
    for p, l in ((jp, jl), (tp, tl)):
        m = p.to_tensor(mask) if masked else None
        out = l(p.to_tensor(x), attn_mask=m)
        _loss(p, out).backward()
        outs.append(out)
    assert_same(*outs, RTOL, ATOL)
    assert_grads(jl, tl, GRAD_RTOL)


def test_transformer_encoder_on_carried_weights():
    def build(p):
        layer = p.nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                             activation="gelu")
        return p.nn.TransformerEncoder(layer, 2)
    jl, tl = _run_layer(build, [_x(0, (2, 16, 32))])
    # the copies are separate parameters with their own names
    names = [p.name for p in tl.parameters()]
    assert len(set(names)) == len(names)
    assert tl.layers[0].linear1.weight is not tl.layers[1].linear1.weight


def test_deepcopy_of_a_layer():
    l = tp.nn.Linear(3, 2)
    c = copy.deepcopy(l)
    np.testing.assert_array_equal(c.weight.numpy(), l.weight.numpy())
    c.weight.set_value(np.zeros((3, 2), np.float32))
    assert np.abs(l.weight.numpy()).sum() > 0
    assert not c.weight.stop_gradient and c.weight.name != l.weight.name


def test_cross_entropy_loss_layer():
    logits, labels = _x(0, (6, 10)), np.array([1, -100, 3, 9, 0, -100])
    outs = [p.nn.CrossEntropyLoss()(p.to_tensor(logits), p.to_tensor(labels))
            for p in (jp, tp)]
    assert_same(*outs, RTOL, ATOL)


def test_batch_norm_train_updates_stats():
    x = _x(0, (4, 3, 5, 5)) * 2 + 1
    outs = []
    for p in (jp, tp):
        bn = p.nn.BatchNorm2D(3)
        y = bn(p.to_tensor(x))
        bn.eval()
        outs.append([y, bn._mean, bn._variance, bn(p.to_tensor(x))])
    for j, t in zip(*outs):
        assert_same(j, t, 1e-5, 1e-5)


def test_adamw_clip_and_schedule_take_layer_parameters():
    """Two AdamW steps over ``layer.parameters()`` with global-norm
    clipping and a cosine schedule: the weights after them equal the JAX
    package's."""
    x = _x(3, (2, 16, 32)) * 5
    jl, tl = jp.nn.Linear(32, 64), tp.nn.Linear(32, 64)
    _carry(jl, tl)
    for p, l in ((jp, jl), (tp, tl)):
        sched = p.optimizer.lr.CosineAnnealingDecay(0.1, T_max=4)
        opt = p.optimizer.AdamW(learning_rate=sched,
                                parameters=l.parameters(),
                                grad_clip=p.nn.ClipGradByGlobalNorm(0.5),
                                weight_decay=0.01)
        for _ in range(2):
            _loss(p, l(p.to_tensor(x))).backward()
            opt.step()
            opt.clear_grad()
            sched.step()
    assert_same([jl.weight, jl.bias], [tl.weight, tl.bias], RTOL, ATOL)


def test_amp_decorate_o2_takes_a_layer():
    """O2 ``decorate`` of a Layer casts the same parameters as the JAX
    package's (LayerNorm stays fp32), in place: the optimizer built
    before it keeps updating them, from fp32 masters."""
    dtypes = []
    for p in (jp, tp):
        net = p.nn.Sequential(p.nn.Linear(32, 32), p.nn.LayerNorm(32))
        opt = p.optimizer.AdamW(parameters=net.parameters())
        leaves = [q._data for q in net.parameters()]
        net, opt = p.amp.decorate(net, opt, level="O2", dtype="bfloat16")
        dtypes.append([str(q.dtype).split(".")[-1].replace("dtype(", "")
                       .strip("')") for q in net.parameters()])
        if p is tp:
            assert all(a is q._data for a, q in zip(leaves,
                                                    net.parameters()))
            with p.amp.auto_cast(level="O2", dtype="bfloat16"):
                net(p.to_tensor(_x(0, (2, 16, 32)))).astype(
                    "float32").sum().backward()
            opt.step()
            assert opt._multi_precision and len(opt._master_weights) == 2
    assert dtypes[0] == dtypes[1] == ["bfloat16", "bfloat16", "float32",
                                      "float32"]
