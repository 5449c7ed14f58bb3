"""``jit.save`` / ``jit.load`` / ``TranslatedLayer`` of the port against
the JAX package's, the same numpy-seeded weights in both.

Every case of ``tests/test_jit_save_load.py`` runs on both packages:
each saves, loads and runs its artifact, and the two loaded programs'
outputs agree within 1e-6 (and each with its own eager model). Then a
tiny BERT classifier saved with ``[-1, -1]`` specs (the port's one
artifact against the JAX artifact of each of two shapes within
``LOSS_ATOL`` of ``test_torch_bert.py``; the JAX package cannot save
BERT with dynamic dims), the exported graph's K1 nodes, the artifacts' formats
across the packages, the ``.pdmodel`` as builtins only, a host read
under export, and ``TracedLayer.save_inference_model`` (the cases of
``tests/test_api_tail.py``). On CPU tensors the K1 op runs its plain
version.
"""
import io
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import load_jax_layer_state

ATOL = 1e-6
LOSS_ATOL = 1e-5
K1 = "paddle_tpu_torch.flash_attention_fwd"


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def small_net(pkg):
    class SmallNet(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg.nn.Linear(8, 32)
            self.fc2 = pkg.nn.Linear(32, 4)

        def forward(self, x):
            return self.fc2(pkg.nn.functional.relu(self.fc1(x)))
    return SmallNet()


def seeded(seed):
    """(JAX SmallNet, port SmallNet) with the same numpy weights."""
    rng = np.random.RandomState(seed)
    jnet = small_net(jp)
    state = {k: (rng.randn(*v.shape) / np.sqrt(v.shape[0])).astype(
        np.float32) for k, v in jnet.state_dict().items()}
    jnet.set_state_dict(state)
    tnet = small_net(tp)
    load_jax_layer_state(tnet, state)
    return jnet, tnet


def out_np(t):
    return np.asarray(t.numpy())


def both(case, tmp_path, seed):
    """Run ``case(pkg, net, path)`` for each package; returns the pairs
    of (loaded output, eager output) it gives, JAX first."""
    jnet, tnet = seeded(seed)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    return (case(jp, jnet, str(tmp_path / "jax" / "model")),
            case(tp, tnet, str(tmp_path / "port" / "model")))


def assert_pairs(jax_pairs, port_pairs):
    for (jl, je), (tl, te) in zip(jax_pairs, port_pairs):
        np.testing.assert_allclose(je, jl, atol=ATOL)
        np.testing.assert_allclose(te, tl, atol=ATOL)
        np.testing.assert_allclose(tl, jl, atol=ATOL)


def test_save_load_round_trip(tmp_path):
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)

    def case(pkg, net, path):
        pkg.jit.save(net, path,
                     input_spec=[pkg.static.InputSpec([4, 8], "float32")])
        loaded = pkg.jit.load(path)
        assert isinstance(loaded, pkg.jit.TranslatedLayer)
        xt = pkg.to_tensor(x)
        return [(out_np(loaded(xt)), out_np(net(xt)))]
    assert_pairs(*both(case, tmp_path, 0))


def test_load_runs_without_model_class(tmp_path):
    """Each package's program runs from its artifact alone (the program
    blob and the state dict), no SmallNet involved."""
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)

    def case(pkg, net, path):
        pkg.jit.save(net, path,
                     input_spec=[pkg.static.InputSpec([2, 8], "float32")])
        with open(path + ".pdmodel", "rb") as f:
            blob = pickle.load(f)
        state = pkg.framework.io.load(path + ".pdparams")
        if pkg is jp:
            from jax import export as jax_export
            fresh = jp.jit.api.TranslatedLayer(
                jax_export.deserialize(blob["stablehlo"]), state)
        else:
            fresh = tp.jit.TranslatedLayer(
                torch.export.load(io.BytesIO(blob["program"])), state)
        xt = pkg.to_tensor(x)
        return [(out_np(fresh(xt)), out_np(net(xt)))]
    assert_pairs(*both(case, tmp_path, 1))


def test_symbolic_batch_dim(tmp_path):
    xs = [np.random.RandomState(2 + b).randn(b, 8).astype(np.float32)
          for b in (1, 3, 16)]

    def case(pkg, net, path):
        pkg.jit.save(net, path,
                     input_spec=[pkg.static.InputSpec([-1, 8], "float32")])
        loaded = pkg.jit.load(path)
        return [(out_np(loaded(pkg.to_tensor(x))),
                 out_np(net(pkg.to_tensor(x)))) for x in xs]
    jax_pairs, port_pairs = both(case, tmp_path, 2)
    assert [p[0].shape[0] for p in port_pairs] == [1, 3, 16]
    assert_pairs(jax_pairs, port_pairs)


def test_to_static_layer_save(tmp_path):
    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)

    def case(pkg, net, path):
        net = pkg.jit.to_static(
            net, input_spec=[pkg.static.InputSpec([4, 8], "float32")])
        xt = pkg.to_tensor(x)
        ref = out_np(net(xt))
        pkg.jit.save(net, path)          # the StaticFunction's input_spec
        return [(out_np(pkg.jit.load(path)(xt)), ref)]
    assert_pairs(*both(case, tmp_path, 3))


def test_set_state_dict_on_translated_layer(tmp_path):
    x = np.random.RandomState(4).randn(2, 8).astype(np.float32)

    def case(pkg, net, path):
        pkg.jit.save(net, path,
                     input_spec=[pkg.static.InputSpec([2, 8], "float32")])
        loaded = pkg.jit.load(path)
        loaded.set_state_dict({k: pkg.to_tensor(np.zeros(v.shape,
                                                         np.float32))
                               for k, v in loaded.state_dict().items()})
        out = out_np(loaded(pkg.to_tensor(x)))
        return [(out, np.zeros_like(out))]
    assert_pairs(*both(case, tmp_path, 4))


def test_train_raises(tmp_path):
    def case(pkg, net, path):
        pkg.jit.save(net, path,
                     input_spec=[pkg.static.InputSpec([2, 8], "float32")])
        loaded = pkg.jit.load(path)
        with pytest.raises(RuntimeError, match="inference program"):
            loaded.train()
        assert loaded.eval() is loaded and not loaded.training
        return []
    both(case, tmp_path, 5)


def test_params_only_fallback(tmp_path):
    """A state dict saved alone (no .pdmodel) loads as a dict."""
    def case(pkg, net, path):
        pkg.framework.io.save(net.state_dict(), path + ".pdparams")
        out = pkg.jit.load(path)
        assert isinstance(out, dict) and "fc1.weight" in out
        return [(out_np(out["fc1.weight"]), out_np(net.fc1.weight))]
    assert_pairs(*both(case, tmp_path, 6))


def test_precompile_and_compile_cache_raise(tmp_path):
    _, net = seeded(7)
    path = str(tmp_path / "model")
    tp.jit.save(net, path, input_spec=[tp.static.InputSpec([2, 8])])
    loaded = tp.jit.load(path)
    with pytest.raises(NotImplementedError, match="compile cache"):
        loaded.precompile([tp.static.InputSpec([2, 8])])
    tp.set_flags({"FLAGS_compile_cache": True})
    try:
        with pytest.raises(NotImplementedError, match="compile cache"):
            loaded(tp.to_tensor(np.zeros((2, 8), np.float32)))
    finally:
        tp.set_flags({"FLAGS_compile_cache": False})


# ------------------------------------------------------------ tiny BERT
TINY_BERT = dict(vocab_size=100, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=256,
                 max_position_embeddings=64, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)


def bert_pair():
    """(JAX, port) BertForSequenceClassification with the same weights."""
    jm = jbert.BertForSequenceClassification(jbert.BertConfig(**TINY_BERT))
    rng = np.random.RandomState(0)
    state = {}
    for key, p in jm.state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("norm.weight"):
            arr = 1.0 + 0.1 * rng.randn(*shape)
        elif key.endswith("bias"):
            arr = 0.1 * rng.randn(*shape)
        elif "embeddings" in key:
            arr = 0.5 * rng.randn(*shape)
        else:
            arr = rng.randn(*shape) / np.sqrt(shape[0])
        state[key] = arr.astype(np.float32)
    jm.set_state_dict(state)
    tm = tbert.BertForSequenceClassification(tbert.BertConfig(**TINY_BERT))
    load_jax_layer_state(tm, state)
    return jm, tm


def bert_inputs(b, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 100, (b, s)).astype(np.int64),
            rng.randint(0, 2, (b, s)).astype(np.int64))


def ids_tensor(pkg, a):
    return pkg.to_tensor(a, dtype="int64")


SHAPES = [(1, 8), (3, 16)]


@pytest.fixture(scope="module")
def bert_artifacts(tmp_path_factory):
    """The port's one artifact with ``[-1, -1]`` specs, and the JAX
    package's at each static shape: its reshape reads the symbolic dims
    as constants (``test_jax_bert_cannot_save_dynamic_dims``)."""
    root = tmp_path_factory.mktemp("bert")
    with tp.device_guard("cpu"):
        jm, tm = bert_pair()
        tp.jit.save(tm, str(root / "port"),
                    input_spec=[tp.static.InputSpec([-1, -1], "int64")] * 2)
        for b, s in SHAPES:
            jp.jit.save(jm, str(root / f"jax_{b}_{s}"),
                        input_spec=[jp.static.InputSpec([b, s], "int64")] * 2)
        return jm, tm, tp.jit.load(str(root / "port")), root


@pytest.mark.parametrize("b,s", SHAPES)
def test_bert_artifact_matches_jax_artifact(bert_artifacts, b, s):
    jm, tm, tl, root = bert_artifacts
    jl = jp.jit.load(str(root / f"jax_{b}_{s}"))
    ids, tt = bert_inputs(b, s, seed=b * 100 + s)
    got = out_np(tl(ids_tensor(tp, ids), ids_tensor(tp, tt)))
    want = out_np(jl(ids_tensor(jp, ids), ids_tensor(jp, tt)))
    assert got.shape == (b, 2)
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL)
    eager = out_np(tm(ids_tensor(tp, ids), ids_tensor(tp, tt)))
    np.testing.assert_allclose(got, eager, atol=ATOL)


def test_jax_bert_cannot_save_dynamic_dims(bert_artifacts, tmp_path):
    """The JAX package's ``jit.save`` of BERT with ``[-1, -1]`` specs
    raises: its ``reshape`` calls ``int()`` on the symbolic dims
    (``paddle_tpu/ops/manipulation.py`` ``_norm_shape``). The port passes
    symbolic sizes through, so its artifact serves every shape."""
    from jax._src.export.shape_poly import InconclusiveDimensionOperation
    jm = bert_artifacts[0]
    with pytest.raises(InconclusiveDimensionOperation):
        jp.jit.save(jm, str(tmp_path / "dyn"),
                    input_spec=[jp.static.InputSpec([-1, -1], "int64")] * 2)


def test_bert_graph_holds_one_k1_node_a_layer(bert_artifacts):
    """The CPU-exported program holds K1 as an op (not the plain
    version's einsums, which would run no kernel on the card): one node
    a layer, no softmax, and both dims symbolic."""
    tl = bert_artifacts[2]
    nodes = list(tl._exported.graph.nodes)
    targets = [str(n.target) for n in nodes if n.op == "call_function"]
    assert sum(t.startswith(K1) for t in targets) == \
        TINY_BERT["num_hidden_layers"]
    assert not any("softmax" in t or "einsum" in t for t in targets)
    ids = [n for n in nodes if n.op == "placeholder"][-2]
    assert all(isinstance(d, torch.SymInt) for d in ids.meta["val"].shape)


def test_artifacts_do_not_cross_packages(bert_artifacts):
    root = bert_artifacts[3]
    with pytest.raises(tp.jit.ArtifactVersionError, match="paddle_tpu.jit"):
        tp.jit.load(str(root / "jax_1_8"))
    with pytest.raises(jp.jit.api.ArtifactVersionError,
                       match="paddle_tpu_torch.jit"):
        jp.jit.load(str(root / "port"))


class _OnlyBuiltins(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name}")


def test_pdmodel_is_builtins_only(bert_artifacts):
    root = bert_artifacts[3]
    with open(str(root / "port") + ".pdmodel", "rb") as f:
        blob = _OnlyBuiltins(f).load()
    assert blob["format"] == "paddle_tpu_torch.jit/1"
    assert blob["n_inputs"] == 2 and blob["platform"] == "cpu"
    assert blob["torch_version"] == str(torch.__version__)
    assert isinstance(blob["program"], bytes)


def test_host_read_under_export_raises_naming_it(tmp_path):
    class Reads(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tp.nn.Linear(8, 4)

        def forward(self, x):
            y = self.fc(x)
            return y * float(y.sum())

    with pytest.raises(tp.core.tensor.GraphBreak, match=r"float\(Tensor\)"):
        tp.jit.save(Reads(), str(tmp_path / "m"),
                    input_spec=[tp.static.InputSpec([-1, 8])])
    _, net = seeded(8)
    tp.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(tp.core.tensor.GraphBreak,
                           match="check_nan_inf scan of op 'linear'"):
            tp.jit.save(net, str(tmp_path / "n"),
                        input_spec=[tp.static.InputSpec([-1, 8])])
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False})


# ------------------------------------------------------------ TracedLayer
def test_traced_layer_fetch_filter(tmp_path):
    rng = np.random.RandomState(9)
    w = rng.randn(3, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    x = np.ones((1, 3), np.float32)
    outs = []
    for pkg in (jp, tp):
        class TwoOut(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = pkg.nn.Linear(3, 3)

            def forward(self, x):
                y = self.lin(x)
                return y, y * 2.0

        net = TwoOut()
        net.set_state_dict({"lin.weight": w, "lin.bias": b})
        xt = pkg.to_tensor(x)
        (_, out1), traced = pkg.jit.TracedLayer.trace(net, [xt])
        path = str(tmp_path / f"fetch_{pkg.__name__}")
        traced.save_inference_model(path, fetch=[1])
        got = out_np(pkg.jit.load(path)(xt))
        np.testing.assert_allclose(got, out_np(out1), rtol=1e-5)
        with pytest.raises(NotImplementedError):
            traced.save_inference_model(str(tmp_path / "feedx"), feed=[0])
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], atol=ATOL)


def test_traced_layer_trace_and_replay(tmp_path):
    rng = np.random.RandomState(10)
    state = {"weight": rng.randn(4, 3).astype(np.float32),
             "bias": rng.randn(3).astype(np.float32)}
    x = rng.randn(2, 4).astype(np.float32)
    outs = []
    for pkg in (jp, tp):
        net = pkg.nn.Linear(4, 3)
        net.set_state_dict(state)
        xt = pkg.to_tensor(x)
        out, traced = pkg.jit.TracedLayer.trace(net, [xt])
        np.testing.assert_allclose(out_np(traced([xt])), out_np(out),
                                   rtol=1e-5)
        path = str(tmp_path / f"traced_{pkg.__name__}")
        traced.save_inference_model(path)
        got = out_np(pkg.jit.load(path)(xt))
        np.testing.assert_allclose(got, out_np(out), rtol=1e-5)
        outs.append(got)
    np.testing.assert_allclose(outs[1], outs[0], atol=ATOL)
