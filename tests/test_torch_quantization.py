"""The port's ``quantization`` against the JAX package's, the same numpy
weights and inputs in both: the JAX quantization cases of
``tests/test_coverage_round2c.py``, ``test_ops_round2b.py``,
``test_round3_fixes.py`` and ``test_round5.py::
test_ptq_jit_save_predictor_parity``, each holding the port to the JAX
outputs (and to the JAX case's own bar). The LLaMA serving case of
``test_round5.py`` waits for the torch-level LLaMA's rebase on
``nn.Layer`` (ROADMAP).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_jax_layer_state

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def np_of(t):
    return np.asarray(t.numpy())


def mlp(pkg, sizes, state=None, seed=0):
    """A Linear/ReLU stack on ``pkg``; the JAX one gets numpy weights,
    which ``state`` carries to the port's."""
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers.append(pkg.nn.Linear(a, b))
        if i < len(sizes) - 2:
            layers.append(pkg.nn.ReLU())
    net = pkg.nn.Sequential(*layers)
    if state is None:
        rng = np.random.RandomState(seed)
        state = {k: (rng.randn(*v.shape) / np.sqrt(v.shape[0])).astype(
            np.float32) for k, v in net.state_dict().items()}
        net.set_state_dict(state)
    else:
        load_jax_layer_state(net, state)
    return net, state


def test_weight_quantize_round_trip():
    w = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    outs = []
    for pkg in (jp, tp):
        Q = pkg.quantization
        q, scale = Q.weight_quantize(pkg.to_tensor(w))
        assert str(q.numpy().dtype) == "int8"
        deq = np_of(Q.weight_dequantize(q, scale))
        assert np.max(np.abs(deq - w)) < np.max(np.abs(w)) / 100
        outs.append((np_of(q), np_of(scale), deq))
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, atol=ATOL)


def test_ptq_swaps_linears():
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    outs, state = [], None
    for pkg in (jp, tp):
        net, state = mlp(pkg, [8, 16, 4], state)
        ref = np_of(net(pkg.to_tensor(x)))
        qnet = pkg.quantization.PTQ().quantize(net)
        kinds = [type(l).__name__ for _, l in qnet.named_sublayers()]
        assert kinds.count("QuantedLinear") == 2
        out = np_of(qnet(pkg.to_tensor(x)))
        assert np.max(np.abs(out - ref)) < 0.1
        assert [type(l).__name__ for _, l in net.named_sublayers()
                ].count("QuantedLinear") == 0      # original untouched
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], atol=ATOL)


def test_qat_trains_with_ste():
    rng = np.random.RandomState(2)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    w = (rng.randn(8, 4) / np.sqrt(8)).astype(np.float32)
    b = (0.1 * rng.randn(4)).astype(np.float32)
    runs = []
    for pkg in (jp, tp):
        net = pkg.nn.Linear(8, 4)
        net.set_state_dict({"weight": w, "bias": b})
        fp_out = np_of(net(pkg.to_tensor(x)))
        pkg.quantization.QAT().quantize(net)
        assert getattr(net, "_qat_wrapped", False)   # root layer wrapped
        qat_out = np_of(net(pkg.to_tensor(x)))
        # fake-quant changes the forward (the weights are rounded)
        assert not np.allclose(qat_out, fp_out, atol=1e-7)
        assert np.max(np.abs(qat_out - fp_out)) < 0.05
        opt = pkg.optimizer.SGD(learning_rate=0.1,
                                parameters=net.parameters())
        xt, yt = pkg.to_tensor(x), pkg.to_tensor(y)
        losses = []
        for _ in range(5):
            loss = pkg.ops.mean((net(xt) - yt) ** 2)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        assert losses[-1] < losses[0]   # the STE lets fp weights learn
        runs.append((qat_out, losses, np_of(net.weight)))
    (jq, jl, jw), (tq, tl, tw) = runs
    np.testing.assert_allclose(tq, jq, atol=ATOL)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tw, jw, atol=1e-5)


def test_weight_only_linear_close_to_fp():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    outs = []
    for pkg in (jp, tp):
        Q = pkg.quantization
        qw, scale = Q.weight_quantize(pkg.to_tensor(w))
        out = np_of(Q.weight_only_linear(pkg.to_tensor(x), qw,
                                         weight_scale=scale))
        ref = x @ w
        assert np.abs(out - ref).max() / np.abs(ref).max() < 0.03
        with_bias = np_of(Q.weight_only_linear(
            pkg.to_tensor(x), qw, bias=pkg.to_tensor(b), weight_scale=scale))
        with pytest.raises(NotImplementedError, match="int4"):
            Q.weight_only_linear(pkg.to_tensor(x), qw, weight_dtype="int4")
        outs.append((out, with_bias))
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_llm_int8_linear_outlier_decomposition():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16).astype(np.float32)
    x[:, 3] *= 50  # outlier column
    w = rng.randn(16, 8).astype(np.float32)
    ref = x @ (np.round(np.clip(w / (np.abs(w).max(0) / 127), -128, 127))
               * (np.abs(w).max(0) / 127))
    outs = []
    for pkg in (jp, tp):
        Q = pkg.quantization
        qw, scale = Q.weight_quantize(pkg.to_tensor(w))
        out = np_of(Q.llm_int8_linear(pkg.to_tensor(x), qw,
                                      weight_scale=scale, threshold=6.0))
        assert np.abs(out - ref).max() / np.abs(ref).max() < 0.05
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-4)


def test_apply_per_channel_scale():
    for pkg in (jp, tp):
        x = pkg.to_tensor(np.full((2, 3), 6.0, np.float32))
        s = pkg.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
        np.testing.assert_allclose(
            np_of(pkg.quantization.apply_per_channel_scale(x, s)),
            [[6, 3, 2], [6, 3, 2]])


def test_llm_int8_activation_gradient_flows_through_int8_path():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 8).astype(np.float32)
    w8 = rng.randint(-127, 127, (8, 5)).astype(np.int8)
    grads = []
    for pkg in (jp, tp):
        xt = pkg.to_tensor(x)
        xt.stop_gradient = False
        out = pkg.quantization.llm_int8_linear(
            xt, pkg.to_tensor(w8),
            weight_scale=pkg.to_tensor(np.full((5,), 0.01, np.float32)),
            threshold=6.0)
        pkg.ops.mean(out ** 2).backward()
        g = np_of(xt.grad)
        # STE: every activation column (none is an outlier) carries a
        # gradient; round()'s zero derivative would kill it
        assert np.abs(g).max() > 1e-6
        assert np.count_nonzero(np.abs(g).sum(axis=0)) == 8
        grads.append(g)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-7)


def test_llm_int8_forward_matches_int8_math():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4).astype(np.float32)
    w8 = rng.randint(-127, 127, (4, 3)).astype(np.int8)
    row_scale = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8)
    aq = np.clip(np.round(x / row_scale), -128, 127)
    ref = (aq @ w8.astype(np.float32)) * row_scale
    outs = []
    for pkg in (jp, tp):
        out = np_of(pkg.quantization.llm_int8_linear(
            pkg.to_tensor(x), pkg.to_tensor(w8), threshold=6.0))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)


def test_ptq_jit_save_predictor_parity(tmp_path):
    """A quantized model through jit.save -> Predictor on both packages:
    each predictor gives its quantized eager model's outputs, and the two
    agree. The port's ``.pdparams`` holds the int8 weights (its
    ``QuantedLinear`` registers them as buffers), under 0.45x of the fp32
    model's bytes."""
    x = np.random.RandomState(5).randn(3, 8).astype(np.float32)
    outs, state = [], None
    for pkg in (jp, tp):
        net, state = mlp(pkg, [8, 32, 4], state, seed=43)
        qnet = pkg.quantization.PTQ().quantize(net)
        ref = np_of(qnet(pkg.to_tensor(x)))
        prefix = str(tmp_path / f"qmodel_{pkg.__name__}")
        pkg.jit.save(qnet, prefix,
                     input_spec=[pkg.static.InputSpec([-1, 8], "float32")])
        cfg = pkg.inference.Config(prefix + ".pdmodel",
                                   prefix + ".pdiparams")
        if pkg is tp:
            cfg.disable_gpu()
        pred = pkg.inference.create_predictor(cfg)
        h = pred.get_input_handle("input_0")
        h.copy_from_cpu(x)
        pred.run()
        got = pred.get_output_handle("output_0").copy_to_cpu()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    saved = tp.load(prefix + ".pdparams")
    assert str(saved["0.qweight"].numpy().dtype) == "int8"

    def nbytes(state):
        return sum(v._data.numel() * v._data.element_size()
                   for v in state.values())
    assert nbytes(saved) < 0.45 * nbytes(net.state_dict())


def test_ptq_bert_runs_where_the_jax_package_raises(tmp_path):
    """PTQ of a BERT classifier: the port's self-attention takes the
    quantized q/k/v projections one by one, and the quantized program
    saves and serves through the predictor. The JAX package's
    self-attention concatenates ``q_proj.weight`` (its fast path), which a
    ``QuantedLinear`` does not have, so its quantized BERT raises."""
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert
    cfg = dict(vocab_size=100, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=256,
               max_position_embeddings=64, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 100, (3, 16)).astype(np.int64)
    jm = jbert.BertForSequenceClassification(jbert.BertConfig(**cfg))
    jq = jp.quantization.PTQ().quantize(jm)
    with pytest.raises(AttributeError, match="weight"):
        jq(jp.to_tensor(ids))
    tm = tbert.BertForSequenceClassification(tbert.BertConfig(**cfg))
    load_jax_layer_state(tm, {k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()})
    tm.eval()
    tq = tp.quantization.PTQ().quantize(tm)
    assert sum(type(l).__name__ == "QuantedLinear"
               for _, l in tq.named_sublayers()) == 2 * 6 + 2
    ids_t = tp.to_tensor(ids, dtype="int64")
    want = np_of(tq(ids_t))
    fp = np_of(tm(ids_t))
    assert np.abs(want - fp).max() < 0.1 * np.abs(fp).max()
    prefix = str(tmp_path / "qbert")
    tp.jit.save(tq, prefix,
                input_spec=[tp.static.InputSpec([-1, -1], "int64")])
    cfg_p = tp.inference.Config(prefix)
    cfg_p.disable_gpu()
    pred = tp.inference.create_predictor(cfg_p)
    pred.get_input_handle("input_0").copy_from_cpu(ids)
    pred.run()
    np.testing.assert_allclose(
        pred.get_output_handle("output_0").copy_to_cpu(), want, atol=1e-5)
