"""``to_static`` over Paddle-API callables (the op-stream capture of
``jit/program.py`` and ``compile/fusion.rewrite_program``) against the
JAX package's ``to_static`` and against the port's own eager runs.

Held, on numpy-seeded inputs at small sizes, each replay on an input of
the recorded signature other than the recorded one:

* ``bench.py``'s fusion block (small size, B4 S128 H256 FF1024, 4 heads)
  in its Paddle-API spelling, closing over its Layers: the fused and
  unfused programs' outputs within OUT_TOL of the JAX ``to_static``'s,
  ``(out*out).mean()`` within OUT_TOL and its gradients within GRAD_RTOL
  norm-wise of ``jax.value_and_grad`` over the JAX program, and the
  JAX pass's stats; the eager ``F.fused_*`` spelling against the JAX
  package's (its Pallas kernels interpreted);
* weights read live: a ``set_value`` and an AdamW step between two
  replays, each against eager;
* a retrace on a new shape and on a new static argument, with the
  compile counters; graph breaks under ``full_graph`` True (raise) and
  False (warn, ``graph_break_reason``, the counter, eager results);
  every kind of break; an ``input_spec`` mismatch;
* a train-mode ResNet-18: outputs and running statistics after two
  calls, and after a running statistic's payload is swapped, equal to
  eager's;
* hapi ``Model`` over a ``to_static`` network (the JAX package's
  ``test_under_to_static`` and a two-epoch ``fit``, equal to eager's and
  to the JAX package's), and ``TracedLayer.trace``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.pallas import fused_ops as JK
from paddle_tpu_torch.core.tensor import GraphBreak
from paddle_tpu_torch.models import load_jax_layer_state
from paddle_tpu_torch.observability import metrics
from test_torch_hapi import _mlp, _state, _xor_ds

OUT_TOL = 1e-5
GRAD_RTOL = 1e-4
B, S, H, FF, HEADS = 4, 128, 256, 1024, 4      # bench.py's small block
FUSED_BLOCK = {"rope_proj": 2, "norm_linear": 1, "residual_norm": 1}
MLP = [8, 16, 2]


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _flags(on):
    jp.set_flags({"FLAGS_enable_fusion": on})
    tp.set_flags({"FLAGS_enable_fusion": on})


@pytest.fixture(params=[False, True], ids=["unfused", "fused"])
def fusion(request):
    old = JK.INTERPRET
    JK.INTERPRET = True
    _flags(request.param)
    yield request.param
    JK.INTERPRET = old
    _flags(False)


@pytest.fixture
def metrics_on():
    tp.set_flags({"FLAGS_enable_metrics": True})
    yield
    tp.set_flags({"FLAGS_enable_metrics": False})


# ------------------------------------------------------ the fusion block
def _block(pkg, layers):
    """bench.py ``_bench_fusion``'s block on ``pkg`` over ``layers``; its
    eager ``F.fused_*`` spelling."""
    q_proj, k_proj, ln2, fc1, fc2 = layers
    F, ops = pkg.nn.functional, pkg.ops
    rope = pkg.models.llama.rotary_embedding
    hd = H // HEADS

    def block(xt):
        hn = F.rms_norm(xt)
        q = rope(ops.reshape(q_proj(hn), [B, S, HEADS, hd]))
        k = rope(ops.reshape(k_proj(hn), [B, S, HEADS, hd]))
        h = fc2(F.gelu(fc1(ln2(xt))))
        s = xt + h
        y = F.rms_norm(s)
        return y + ops.reshape(q, [B, S, H]) + ops.reshape(k, [B, S, H])

    def fused(xt):
        hn = F.rms_norm(xt)
        q = F.fused_rope_proj(hn, q_proj.weight, q_proj.bias,
                              num_heads=HEADS)
        k = F.fused_rope_proj(hn, k_proj.weight, k_proj.bias,
                              num_heads=HEADS)
        h = fc2(F.fused_norm_linear(
            xt, fc1.weight, fc1.bias, ln2.weight, ln2.bias,
            activation="gelu", norm_type="layer_norm"))
        y, _ = F.fused_residual_norm(xt, h, norm_type="rms_norm",
                                     epsilon=1e-6)
        return y + ops.reshape(q, [B, S, H]) + ops.reshape(k, [B, S, H])
    return block, fused


def _block_layers(pkg):
    nn = pkg.nn
    return (nn.Linear(H, H), nn.Linear(H, H), nn.LayerNorm(H),
            nn.Linear(H, FF), nn.Linear(FF, H))


def _block_pair():
    """The block's Layers in both packages, the port's with the JAX
    layers' weights (norm gains and biases moved off 1 and 0)."""
    jp.seed(0)
    j_layers = _block_layers(jp)
    rng = np.random.RandomState(5)
    for layer in j_layers:
        for name, p in layer.named_parameters():
            if name in ("weight", "bias") and isinstance(layer, jp.nn.LayerNorm):
                p.set_value(np.asarray(p.numpy()) + 0.1 * rng.randn(
                    *p.shape).astype(np.float32))
    t_layers = _block_layers(tp)
    for j, t in zip(j_layers, t_layers):
        load_jax_layer_state(t, _state(j))
    return j_layers, t_layers


def _x(seed):
    return (np.random.RandomState(seed).randn(B, S, H) * 0.5).astype(
        np.float32)


def _jax_block_program(j_layers, x):
    """The JAX ``to_static`` block: its output, and ``(out*out).mean()``
    and the gradients of the layers' parameters by ``value_and_grad``."""
    block, _ = _block(jp, j_layers)
    out = np.asarray(jp.jit.to_static(block, full_graph=True)(
        JTensor(jnp.asarray(x))).numpy())
    params = [p for m in j_layers for p in m.parameters()]
    # a fresh program whose first trace runs under value_and_grad, as
    # bench.py's train leg runs it: the JAX program bakes the payloads of
    # the parameters it closes over at its first trace
    sf = jp.jit.to_static(block, full_graph=True)

    def loss_of(arrays):
        originals = [p._data for p in params]
        for p, a in zip(params, arrays):
            p._data = a
        try:
            o = sf(JTensor(jnp.asarray(x)))._data
            return (o * o).mean()
        finally:
            for p, o in zip(params, originals):
                p._data = o

    loss, grads = jax.value_and_grad(loss_of)([p._data for p in params])
    return out, float(loss), [np.asarray(g) for g in grads], sf.fusion_stats


def test_fusion_block_program_matches_jax(fusion):
    j_layers, t_layers = _block_pair()
    x = _x(1)
    j_out, j_loss, j_grads, j_stats = _jax_block_program(j_layers, x)
    block, _ = _block(tp, t_layers)
    sf = tp.jit.to_static(block, full_graph=True)
    sf(tp.to_tensor(_x(2)))                      # records
    out = sf(tp.to_tensor(x))                    # replays
    np.testing.assert_allclose(out.numpy(), j_out, atol=OUT_TOL,
                               rtol=OUT_TOL)
    loss = (out * out).mean()
    loss.backward()
    assert abs(float(loss.numpy()) - j_loss) <= OUT_TOL * abs(j_loss)
    params = [p for m in t_layers for p in m.parameters()]
    for p, g in zip(params, j_grads):
        err = np.linalg.norm(p.grad.numpy() - g) / np.linalg.norm(g)
        assert err <= GRAD_RTOL, (p.name, err)
    if not fusion:
        assert sf.fusion_stats is None and j_stats is None
        return
    for key in ("matched", "rewritten", "rejected"):
        assert sf.fusion_stats[key] == j_stats[key]
    assert sf.fusion_stats["rewritten"] == FUSED_BLOCK
    assert sf.fusion_stats["rejected"] == {"norm_linear": 1}


def test_fusion_block_eager_fused_spelling_matches_jax():
    """The ``F.fused_*`` ops on Paddle Tensors (K4, K6, K7's plain
    versions here) against the JAX package's (the Pallas kernels
    interpreted), and against the unfused block."""
    old = JK.INTERPRET
    JK.INTERPRET = True
    try:
        j_layers, t_layers = _block_pair()
        x = _x(3)
        _, j_fused = _block(jp, j_layers)
        want = np.asarray(j_fused(JTensor(jnp.asarray(x))).numpy())
    finally:
        JK.INTERPRET = old
    block, fused = _block(tp, t_layers)
    got = fused(tp.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(got, block(tp.to_tensor(x)).numpy(),
                               atol=OUT_TOL, rtol=OUT_TOL)


def test_replay_reads_closed_over_weights_live():
    """The block closes over its Layers, whose parameters reach the
    recorder only as inputs of recorded ops: a ``set_value`` on a weight
    and an AdamW step between replays show in the next replay, as in
    eager."""
    _flags(True)
    try:
        _, t_layers = _block_pair()
        block, _ = _block(tp, t_layers)
        sf = tp.jit.to_static(block, full_graph=True)
        sf(tp.to_tensor(_x(4)))
        x = tp.to_tensor(_x(5))

        def check():
            np.testing.assert_allclose(sf(x).numpy(), block(x).numpy(),
                                       atol=OUT_TOL, rtol=OUT_TOL)
        check()
        w = t_layers[0].weight
        w.set_value(w.numpy() * 0.5 + 0.01)
        check()
        params = [p for m in t_layers for p in m.parameters()]
        opt = tp.optimizer.AdamW(learning_rate=1e-2, parameters=params)
        out = sf(x)
        (out * out).mean().backward()
        opt.step()
        opt.clear_grad()
        check()
        assert sf.fusion_stats["rewritten"] == FUSED_BLOCK
    finally:
        _flags(False)


# ------------------------------------------------------------- signatures
def _counter(name, label):
    return metrics.counter(name, labelnames=(label,))


def test_retrace_on_a_new_shape_and_static_argument(metrics_on):
    compiles = _counter("paddle_tpu_to_static_compile_total", "kind")
    reasons = _counter("paddle_tpu_to_static_retrace_total", "reason")
    before = {k: compiles.value(kind=k) for k in ("initial", "retrace")}
    why = {k: reasons.value(reason=k)
           for k in ("new_input_shapes", "new_static_args")}
    net = _mlp(tp, MLP)

    def fn(x, scale):
        return net(x) * scale
    sf = tp.jit.to_static(fn)
    rng = np.random.RandomState(0)
    xs = [tp.to_tensor(rng.randn(n, 8).astype(np.float32))
          for n in (4, 4, 6)]
    for x, scale in zip(xs, (2.0, 2.0, 2.0)):
        np.testing.assert_allclose(sf(x, scale).numpy(),
                                   (net(x) * scale).numpy(), rtol=1e-6)
    sf(xs[0], 3.0)
    assert len(sf._programs) == 3
    assert compiles.value(kind="initial") == before["initial"] + 1
    assert compiles.value(kind="retrace") == before["retrace"] + 2
    assert reasons.value(reason="new_input_shapes") == \
        why["new_input_shapes"] + 1
    assert reasons.value(reason="new_static_args") == \
        why["new_static_args"] + 1


def _breaks_on_numpy(net):
    def fn(x):
        y = net(x)
        if float(y.numpy().sum()) > 1e9:      # a host read
            y = y * 2
        return y + 1
    return fn


def test_graph_break_with_full_graph_raises():
    net = _mlp(tp, MLP)
    sf = tp.jit.to_static(_breaks_on_numpy(net), full_graph=True)
    with pytest.raises(GraphBreak, match=r"Tensor\.numpy\(\)"):
        sf(tp.to_tensor(np.ones((2, 8), np.float32)))


def test_graph_break_without_full_graph_runs_eagerly(metrics_on):
    breaks = _counter("paddle_tpu_graph_break_total", "reason")
    before = breaks.value(reason="GraphBreak")
    net = _mlp(tp, MLP)
    fn = _breaks_on_numpy(net)
    sf = tp.jit.to_static(fn)
    x = tp.to_tensor(np.random.RandomState(1).randn(2, 8).astype(np.float32))
    with pytest.warns(UserWarning, match="graph break"):
        out = sf(x)
    assert "Tensor.numpy()" in sf.graph_break_reason
    assert breaks.value(reason="GraphBreak") == before + 1
    np.testing.assert_array_equal(out.numpy(), fn(x).numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no second warning
        np.testing.assert_array_equal(sf(x).numpy(), fn(x).numpy())
    assert not sf._programs


BREAKS = {
    "item": lambda x, net, opt: x.sum().item(),
    "tolist": lambda x, net, opt: x.tolist(),
    "bool": lambda x, net, opt: bool(x.sum() > 0),
    "float": lambda x, net, opt: float(x.sum()),
    "cpu": lambda x, net, opt: x.cpu(),
    "set_value": lambda x, net, opt: net[0].bias.set_value(
        np.zeros(16, np.float32)),
    "argument_in_place": lambda x, net, opt: x.add_(x),
    "randn": lambda x, net, opt: tp.randn([2]),
    "backward": lambda x, net, opt: net(x).sum().backward(),
    "optimizer": lambda x, net, opt: opt.step(),
}


@pytest.mark.parametrize("kind", sorted(BREAKS))
def test_each_kind_of_break_raises_under_full_graph(kind):
    net = _mlp(tp, MLP)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())

    def fn(x):
        y = net(x)
        BREAKS[kind](x, net, opt)
        return y
    x = tp.to_tensor(np.ones((2, 8), np.float32))
    x.stop_gradient = False
    with pytest.raises(GraphBreak):
        tp.jit.to_static(fn, full_graph=True)(x)


def test_an_argument_passed_twice_is_its_own_signature():
    sf = tp.jit.to_static(lambda a, b: a * 2 + b)
    rng = np.random.RandomState(6)
    x, y = (tp.to_tensor(rng.randn(3).astype(np.float32)) for _ in range(2))
    np.testing.assert_array_equal(sf(x, x).numpy(), (x * 2 + x).numpy())
    np.testing.assert_array_equal(sf(x, y).numpy(), (x * 2 + y).numpy())
    assert len(sf._programs) == 2


def test_temporaries_detach_and_constants_replay():
    """A constant made in the call, written in place (``setitem``), a
    ``detach`` and an in-place op on a temporary replay as eager runs
    them on a second input."""
    def fn(x):
        z = tp.zeros([2, 8])
        z[0] = x[1]
        y = (x * 2).detach()
        y.add_(z)
        return y + tp.ops.arange(0, 8, dtype="float32")
    sf = tp.jit.to_static(fn, full_graph=True)
    rng = np.random.RandomState(2)
    xs = [tp.to_tensor(rng.randn(2, 8).astype(np.float32)) for _ in range(3)]
    for x in xs:
        np.testing.assert_array_equal(sf(x).numpy(), fn(x).numpy())
    assert len(sf._programs) == 1


def test_the_recording_keeps_no_activation_alive():
    """Once the recording call returns and its outputs are dropped, none
    of its intermediate payloads is alive, without a cyclic collection
    (a BERT-base recording holds about 10 GB of them on the card)."""
    import gc
    import weakref
    from paddle_tpu_torch.core import dispatch
    net = _mlp(tp, MLP)
    refs = []

    def tap(op, ins, outs, attrs, dur):
        refs.extend(weakref.ref(o._data) for o in outs)
    sf = tp.jit.to_static(lambda x: net(x) * 2)
    x = tp.to_tensor(np.ones((4, 8), np.float32))
    gc.disable()
    dispatch.register_op_hook(tap)
    try:
        out = sf(x)
        del out
        alive = [r for r in refs if r() is not None]
    finally:
        dispatch.unregister_op_hook(tap)
        gc.enable()
    assert refs and not alive, f"{len(alive)} of {len(refs)} alive"
    assert sf._programs


def test_input_spec_mismatch_raises():
    from paddle_tpu_torch.static import InputSpec
    net = _mlp(tp, MLP)
    sf = tp.jit.to_static(lambda x: net(x),
                          input_spec=[InputSpec([None, 8], "float32")])
    sf(tp.to_tensor(np.ones((3, 8), np.float32)))
    with pytest.raises(ValueError, match="input_spec"):
        sf(tp.to_tensor(np.ones((3, 9), np.float32)))
    with pytest.raises(ValueError, match="input_spec"):
        sf(tp.to_tensor(np.ones((3, 8), np.int32)))


def test_mixed_tensor_kinds_raise_and_helpers():
    sf = tp.jit.to_static(lambda a, b: a)
    with pytest.raises(TypeError, match="mix"):
        sf(tp.to_tensor(np.ones(2, np.float32)), torch.ones(2))
    seen = []

    def fn(x):
        seen.append(tp.jit.in_capture_mode())
        return x + 1
    assert tp.jit.to_static(tp.jit.not_to_static(fn)) is fn
    g = tp.jit.to_static(lambda x: fn(x))
    for _ in range(2):
        g(tp.to_tensor(np.ones(2, np.float32)))
    assert seen == [True] and not tp.jit.in_capture_mode()
    assert tp.jit.ignore_module([np]) is None


# ----------------------------------------------------- batch norm buffers
def test_resnet18_train_mode_running_statistics():
    """Batch norm's running statistics are inputs of its op, updated in
    place: after two calls (record, replay), and after a running mean's
    payload is swapped by ``set_value``, the static model's outputs and
    statistics equal an eager twin's."""
    tp.seed(0)
    eager = tp.vision.models.resnet18(num_classes=10)
    static = tp.vision.models.resnet18(num_classes=10)
    static.set_state_dict(eager.state_dict())
    tp.jit.to_static(static, full_graph=True)
    rng = np.random.RandomState(0)
    xs = [tp.to_tensor(rng.randn(2, 3, 32, 32).astype(np.float32))
          for _ in range(3)]

    def step(x):
        np.testing.assert_allclose(static(x).numpy(), eager(x).numpy(),
                                   atol=1e-5, rtol=1e-5)
        for (name, a), (_, b) in zip(static.named_buffers(),
                                     eager.named_buffers()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=name)
    step(xs[0])
    step(xs[1])
    for model in (static, eager):
        bn = model.bn1
        bn._mean.set_value(np.full(bn._mean.shape, 0.25, np.float32))
    step(xs[2])
    assert len(static.forward._programs) == 1


# ------------------------------------------------------------ hapi, trace
def test_under_to_static():
    """The JAX package's ``TestBert.test_under_to_static`` on the port,
    and the program against the JAX package's ``to_static``."""
    from paddle_tpu.models.bert import BertConfig as JCfg
    from paddle_tpu.models.bert import BertForSequenceClassification as JCls
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    cfg = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=128,
               max_position_embeddings=32, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    jp.seed(2)
    jm = JCls(JCfg(**cfg), num_classes=2)
    m = BertForSequenceClassification(BertConfig(**cfg), num_classes=2)
    load_jax_layer_state(m, _state(jm))
    jm.eval()
    m.eval()
    ids = np.random.RandomState(0).randint(0, 128, (2, 16))
    ref = m(tp.to_tensor(ids)).numpy()
    st = tp.jit.to_static(m)
    for seed in (1, 0):               # records on another batch, replays
        out = st(tp.to_tensor(np.random.RandomState(seed).randint(
            0, 128, (2, 16)))).numpy()
    np.testing.assert_allclose(ref, out, atol=1e-5)
    j_out = np.asarray(jp.jit.to_static(jm)(jp.to_tensor(ids)).numpy())
    np.testing.assert_allclose(out, j_out, atol=1e-5)


def _fit(pkg, net):
    model = pkg.hapi.Model(net)
    model.prepare(
        optimizer=pkg.optimizer.AdamW(learning_rate=1e-2,
                                      parameters=net.parameters()),
        loss=pkg.nn.CrossEntropyLoss())
    return model.fit(_xor_ds(pkg), batch_size=8, epochs=2, verbose=0,
                     shuffle=False)


def test_hapi_fit_over_a_to_static_network():
    """Two epochs of ``Model.fit`` over a ``to_static`` network: the
    loss history of the eager network's fit and of the JAX package's."""
    jp.seed(0)
    j_net = _mlp(jp, MLP)
    nets = []
    for _ in range(2):
        net = _mlp(tp, MLP)
        load_jax_layer_state(net, _state(j_net))
        nets.append(net)
    want = _fit(jp, j_net)
    eager = _fit(tp, nets[0])
    static = _fit(tp, tp.jit.to_static(nets[1], full_graph=True))
    np.testing.assert_allclose(static, eager, rtol=0, atol=1e-6)
    np.testing.assert_allclose(static, want, rtol=0, atol=1e-5)
    assert nets[1].forward._programs


def test_traced_layer(tmp_path):
    net = _mlp(tp, MLP)
    rng = np.random.RandomState(3)
    x, x2 = (tp.to_tensor(rng.randn(4, 8).astype(np.float32))
             for _ in range(2))
    out, traced = tp.jit.TracedLayer.trace(net, [x])
    np.testing.assert_array_equal(out.numpy(), net(x).numpy())
    np.testing.assert_array_equal(traced([x2]).numpy(), net(x2).numpy())
    path = traced.save_inference_model(str(tmp_path / "traced"))
    np.testing.assert_allclose(tp.jit.load(path)(x2).numpy(),
                               net(x2).numpy(), atol=1e-6)
    with pytest.raises(NotImplementedError, match="feed"):
        traced.save_inference_model(str(tmp_path / "feed"), feed=[0])
