"""The port's ``static.Program``/``program_guard``/``data``/``Executor``
against the JAX package's (the cases of ``tests/test_static_program.py``,
the static pattern corpus of ``tests/test_fusion.py`` through each
package's ``fuse_program_ops``, and a 2-layer BERT served from a
Program).

Each case builds the same program in both packages; the port program
takes the JAX program's parameters (``models.load_jax_program_state``)
and both run on the same numpy-seeded feeds. Held: fp32 outputs within
TOL (atol and rtol 1e-5), the recorded op names, the plan cache's
growth, the fusion pass's stats. The JAX fused programs run their
Pallas kernels in the interpreter (``INTERPRET``), as the JAX package's
own tests run them on the CPU.
"""
import threading

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.compile import fusion as jfusion
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import fused_ops as JK
from paddle_tpu_torch.compile import fusion as tfusion
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import (load_jax_layer_state,
                                     load_jax_program_state)
from test_torch_bert import seeded_state

TOL = dict(rtol=1e-5, atol=1e-5)
STAT_KEYS = ("matched", "rewritten", "rejected")


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


@pytest.fixture
def fused():
    old = JK.INTERPRET
    JK.INTERPRET = True
    for pkg in (jp, tp):
        pkg.set_flags({"FLAGS_enable_fusion": True})
    yield
    JK.INTERPRET = old
    for pkg in (jp, tp):
        pkg.set_flags({"FLAGS_enable_fusion": False})


def persistables(program):
    """A JAX program's persistable captured tensors, in recording
    order."""
    return [np.asarray(t.numpy()) for t in program._captured.values()
            if getattr(t, "persistable", False)]


def build_both(build, seed=0):
    """``build(pkg)`` under each package's ``program_guard``: ((JAX
    program, its fetches), (port program, its fetches)), the port
    program on the JAX program's parameters."""
    jp.seed(seed)
    jm = jp.static.Program()
    with jp.static.program_guard(jm):
        jo = build(jp)
    tm = tp.static.Program()
    with tp.static.program_guard(tm):
        to = build(tp)
    load_jax_program_state(tm, persistables(jm))
    return (jm, list(jo)), (tm, list(to))


def run_both(j, t, feed):
    """Both programs over ``feed``, their fetches held within TOL;
    returns the port's."""
    (jm, jf), (tm, tf) = j, t
    want = jp.static.Executor().run(jm, feed=feed, fetch_list=jf)
    got = tp.static.Executor().run(tm, feed=feed, fetch_list=tf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    return got


def names(program):
    return [op.name for op in program.global_block().ops]


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------ build and run
def test_fc_network_batch_polymorphic():
    def build(pkg):
        x = pkg.static.data("x", [None, 8], "float32")
        h = pkg.static.nn.fc(x, 16, activation="relu")
        return [pkg.static.nn.fc(h, 4)]
    j, t = build_both(build)
    for b in (2, 5):
        (o,) = run_both(j, t, {"x": rand(b, b, 8)})
        assert o.shape == (b, 4)


def test_matches_eager():
    def build(pkg):
        x = pkg.static.data("x", [4, 6], "float32")
        return [(x * 2 + 1).tanh().sum()]
    xv = rand(0, 4, 6)
    (got,) = run_both(*build_both(build), {"x": xv})
    np.testing.assert_allclose(got, np.tanh(xv * 2 + 1).sum(), rtol=1e-5)


def test_two_feeds():
    def build(pkg):
        a = pkg.static.data("a", [None, 3], "float32")
        b = pkg.static.data("b", [None, 3], "float32")
        return [a @ b.t() + 1]
    run_both(*build_both(build), {"a": rand(1, 2, 3), "b": rand(2, 2, 3)})


def test_weights_are_live_captures():
    """A captured tensor changed between runs changes the next run."""
    made = {}

    def build(pkg):
        x = pkg.static.data("x", [2, 2], "float32")
        made[pkg] = w = pkg.to_tensor(np.eye(2, dtype=np.float32))
        return [x @ w]
    j, t = build_both(build)
    xv = np.array([[1, 2], [3, 4]], np.float32)
    np.testing.assert_allclose(run_both(j, t, {"x": xv})[0], xv)
    for pkg, w in made.items():
        w.set_value(pkg.to_tensor(2 * np.eye(2, dtype=np.float32)))
    np.testing.assert_allclose(run_both(j, t, {"x": xv})[0], 2 * xv)


def test_a_swapped_parameter_is_read_live():
    """``set_program_state`` between runs: the next run reads the new
    weights (the JAX package's program too)."""
    def build(pkg):
        x = pkg.static.data("x", [None, 3], "float32")
        return [pkg.static.nn.fc(x, 2)]
    j, t = build_both(build)
    xv = rand(3, 4, 3)
    run_both(j, t, {"x": xv})
    state = {k: 3.0 * v.numpy() for k, v in
             jp.static.tail._program_params(j[0]).items()}
    jp.static.set_program_state(j[0], state)
    tp.static.set_program_state(t[0], dict(zip(
        tp.static.tail._program_params(t[0]), state.values())))
    run_both(j, t, {"x": xv})


def test_embedding():
    def build(pkg):
        ids = pkg.static.data("ids", [None, 5], "int64")
        return [pkg.static.nn.embedding(ids, size=[10, 4])]
    ids = np.random.RandomState(4).randint(0, 10, (2, 5))
    (e,) = run_both(*build_both(build), {"ids": ids})
    assert e.shape == (2, 5, 4)


# ----------------------------------------------------------- semantics
def test_introspection():
    def build(pkg):
        x = pkg.static.data("x", [2, 2], "float32")
        return [(x + 1) * 3]
    (jm, _), (tm, _) = build_both(build)
    assert "Program(feeds=[x:" in tm.to_string()
    assert names(tm) == names(jm) == ["add", "multiply"]
    assert len(tm.list_vars()) == len(jm.list_vars())


def test_data_outside_guard_raises():
    for pkg in (jp, tp):
        with pytest.raises(RuntimeError, match="program_guard"):
            pkg.static.data("x", [2, 2])


def test_missing_feed_raises():
    def build(pkg):
        x = pkg.static.data("x", [2, 2], "float32")
        return [x + 1]
    for main, fetch in build_both(build):
        pkg = jp if isinstance(main, jp.static.Program) else tp
        with pytest.raises(KeyError, match="missing feeds"):
            pkg.static.Executor().run(main, feed={}, fetch_list=fetch)


def test_recording_stops_after_guard():
    for pkg in (jp, tp):
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [2, 2], "float32")
            x + 1
        n = len(main.global_block().ops)
        pkg.to_tensor(np.ones((2, 2), np.float32)) * 5
        assert len(main.global_block().ops) == n == 1


def test_nested_guard_inner_only():
    progs = {}
    for pkg in (jp, tp):
        p1, p2 = pkg.static.Program(), pkg.static.Program()
        with pkg.static.program_guard(p1):
            a = pkg.static.data("a", [1], "float32")
            with pkg.static.program_guard(p2):
                b = pkg.static.data("b", [1], "float32")
                doubled = b * 2
            y = a + 1
        assert names(p1) == ["add"] and names(p2) == ["multiply"]
        exe = pkg.static.Executor()
        progs[pkg] = (
            exe.run(p1, feed={"a": np.array([3.0], np.float32)},
                    fetch_list=[y])[0],
            exe.run(p2, feed={"b": np.array([5.0], np.float32)},
                    fetch_list=[doubled])[0])
    for got, want in zip(progs[tp], progs[jp]):
        np.testing.assert_allclose(got, np.asarray(want))
    np.testing.assert_allclose(progs[tp][0], [4.0])
    np.testing.assert_allclose(progs[tp][1], [10.0])


def test_default_main_program():
    for pkg in (jp, tp):
        prog = pkg.static.default_main_program()
        assert isinstance(prog, pkg.static.Program)
        assert pkg.static.CompiledProgram(prog).program is prog
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            assert pkg.static.default_main_program() is main
        assert isinstance(pkg.static.default_startup_program(),
                          pkg.static.Program)


def test_plan_cache_reused_and_grown_as_the_jax_cache():
    def build(pkg):
        x = pkg.static.data("x", [None, 4], "float32")
        return [x.sum()]
    j, t = build_both(build)
    sizes = []
    for xv in (np.ones((2, 4), np.float32), np.full((2, 4), 3.0, np.float32),
               np.ones((5, 4), np.float32)):
        run_both(j, t, {"x": xv})
        sizes.append((len(t[0]._plans), len(j[0]._jit_cache)))
    assert sizes == [(1, 1), (1, 1), (2, 2)]


# -------------------------------------------------------------- attrs
def test_fc_bias_attr_false():
    def build(pkg):
        x = pkg.static.data("x", [2, 3], "float32")
        return [pkg.static.nn.fc(x, 4, bias_attr=False)]
    (out,) = run_both(*build_both(build),
                      {"x": np.zeros((2, 3), np.float32)})
    np.testing.assert_allclose(out, 0.0)


def test_embedding_dtype_selects_weight_dtype():
    for pkg in (jp, tp):
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            ids = pkg.static.data("ids", [2, 2], "int64")
            out = pkg.static.nn.embedding(ids, [4, 3], dtype="bfloat16")
        assert "bfloat16" in str(out.dtype)


def test_recorder_is_thread_local():
    for pkg in (jp, tp):
        main = pkg.static.Program()
        done = threading.Event()

        def other_thread():
            t = pkg.to_tensor(np.ones((2, 2), np.float32))
            t * 3 + 1
            done.set()

        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [2, 2], "float32")
            th = threading.Thread(target=other_thread)
            th.start()
            th.join()
            x + 1
        assert done.is_set()
        assert names(main) == ["add"]


def test_placeholder_pinned_under_no_grad():
    def build(pkg):
        with pkg.no_grad():
            y = pkg.static.data("x", [2, 2], "float32") + 1.0
            for _ in range(8):
                c = pkg.to_tensor(np.full((2, 2), 103.0, np.float32))
                y = y + 0.0 * c
        return [y]
    (out,) = run_both(*build_both(build),
                      {"x": np.full((2, 2), 103.0, np.float32)})
    np.testing.assert_allclose(out, 104.0)


def test_extend_program_replans():
    feed = {"x": np.array([1.0, 2.0], np.float32)}
    got = {}
    for pkg in (jp, tp):
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [2], "float32")
            y = x + 1
        exe = pkg.static.Executor()
        first = exe.run(main, feed, [y])[0]
        with pkg.static.program_guard(main):
            z = y + pkg.to_tensor(np.array([10.0, 20.0], np.float32))
        got[pkg] = [first, exe.run(main, feed, [y])[0],
                    exe.run(main, feed, [z])[0]]
    for g, w in zip(got[tp], got[jp]):
        np.testing.assert_allclose(g, np.asarray(w))
    np.testing.assert_allclose(got[tp][2], [12, 23])


def test_feed_dtype_declaration_honored():
    def build(pkg):
        x = pkg.static.data("x", [2], "float32")
        return [x / 2]
    (out,) = run_both(*build_both(build),
                      {"x": np.array([1, 3], np.int32)})
    np.testing.assert_allclose(out, [0.5, 1.5])


def test_a_fetch_changed_in_place_is_fetched_changed():
    """An in-place op swaps the Tensor's payload: the port fetches the
    value eager code reads (the JAX program keys the fetch on the Tensor
    and returns the value before the op, ROADMAP Queue 3)."""
    main = tp.static.Program()
    with tp.static.program_guard(main):
        x = tp.static.data("x", [3], "float32")
        y = x * 2
        y.add_(tp.to_tensor(np.ones(3, np.float32)))
    xv = rand(5, 3)
    (got,) = tp.static.Executor().run(main, {"x": xv}, [y])
    np.testing.assert_allclose(got, xv * 2 + 1, **TOL)


def test_a_captured_tensor_changed_in_place_in_the_block():
    """A tensor made in the block, read by an op and then changed by an
    in-place op: the op before the change reads the value it had, the op
    after reads the changed one, as in eager code."""
    main = tp.static.Program()
    with tp.static.program_guard(main):
        x = tp.static.data("x", [3], "float32")
        w = tp.to_tensor(np.full(3, 2.0, np.float32))
        before = x * w
        w.add_(tp.to_tensor(np.ones(3, np.float32)))
        after = x * w
    xv = rand(6, 3)
    got = tp.static.Executor().run(main, {"x": xv}, [before, after, w])
    for g, want in zip(got, (xv * 2.0, xv * 3.0, np.full(3, 3.0))):
        np.testing.assert_allclose(g, want, **TOL)


def test_return_numpy_false_gives_tensors():
    main = tp.static.Program()
    with tp.static.program_guard(main):
        x = tp.static.data("x", [2], "float32")
        y = x + 1
    (t,) = tp.static.Executor().run(main, {"x": np.zeros(2, np.float32)},
                                    [y], return_numpy=False)
    assert isinstance(t, tp.Tensor) and t._data.device.type == "cpu"
    np.testing.assert_allclose(t.numpy(), [1.0, 1.0])


# -------------------------------------------------- the pattern corpus
W32x64 = rand(11, 32, 64) * 0.1
B64 = rand(12, 64) * 0.1
B32 = rand(13, 32) * 0.1


def _norm_linear_act(pkg, F, llama):
    x = pkg.static.data("x", [4, 32], "float32")
    h = F.layer_norm(x, [32])
    return [F.gelu(F.linear(h, pkg.to_tensor(W32x64), pkg.to_tensor(B64)))]


def _gelu_tanh(pkg, F, llama):
    x = pkg.static.data("x", [4, 32], "float32")
    return [F.gelu(F.linear(F.rms_norm(x), pkg.to_tensor(W32x64)),
                   approximate=True)]


def _interior_fetch(pkg, F, llama):
    x = pkg.static.data("x", [4, 32], "float32")
    h = F.layer_norm(x, [32])
    return [h, F.gelu(F.linear(h, pkg.to_tensor(W32x64)))]


def _interior_multi_consumer(pkg, F, llama):
    x = pkg.static.data("x", [4, 32], "float32")
    h = F.layer_norm(x, [32])
    return [F.gelu(F.linear(h, pkg.to_tensor(W32x64))), h * 2.0]


def _residual_norm(pkg, F, llama):
    x = pkg.static.data("x", [4, 8, 32], "float32")
    y = pkg.static.data("y", [4, 8, 32], "float32")
    s = x + y
    return [F.rms_norm(s), s.mean()]


def _bias_act(pkg, F, llama):
    x = pkg.static.data("x", [4, 32], "float32")
    return [F.silu(x + pkg.to_tensor(B32))]


def _linear_act(pkg, F, llama):
    x = pkg.static.data("x", [4, 32], "float32")
    return [F.relu(F.linear(x, pkg.to_tensor(W32x64)))]


def _rope_proj(pkg, F, llama):
    x = pkg.static.data("x", [2, 8, 32], "float32")
    h = pkg.reshape(F.linear(x, pkg.to_tensor(W32x64)), [2, 8, 4, 16])
    return [llama.rotary_embedding(h)]


def _unrelated(pkg, F, llama):
    x = pkg.static.data("x", [4, 32], "float32")
    return [pkg.tanh(x) * 2.0]


CORPUS = {
    "norm_linear_act": (_norm_linear_act, {"norm_linear": 1}),
    "gelu_tanh": (_gelu_tanh, {"norm_linear": 1}),
    "interior_fetch": (_interior_fetch, {"linear_act": 1}),
    "interior_multi_consumer": (_interior_multi_consumer,
                                {"linear_act": 1}),
    "residual_norm": (_residual_norm, {"residual_norm": 1}),
    "bias_act": (_bias_act, {"bias_act": 1}),
    "linear_act": (_linear_act, {"linear_act": 1}),
    "rope_proj": (_rope_proj, {"rope_proj": 1}),
    "unrelated": (_unrelated, {}),
}


@pytest.mark.parametrize("case", list(CORPUS))
def test_pattern_corpus_through_fuse_program_ops(case, fused):
    """The plan of each package's ``fuse_program_ops`` (the fetches as
    the external set): the same stats and fused op names; then each
    program run fused, the same outputs and ``fusion_stats``."""
    build, want = CORPUS[case]
    j, t = build_both(lambda pkg: build(
        pkg, pkg.nn.functional, jllama if pkg is jp else tllama))
    (jm, jf), (tm, tf) = j, t
    j_plan, j_stats = jfusion.fuse_program_ops(jm._block.ops,
                                               [id(v) for v in jf])
    t_plan, t_stats = tfusion.fuse_program_ops(
        tm._block.ops, [tm._fetch_id(v) for v in tf])
    assert {k: t_stats[k] for k in STAT_KEYS} == \
        {k: j_stats[k] for k in STAT_KEYS}
    assert t_stats["rewritten"] == want
    assert [s.name for s in t_plan] == [s.name for s in j_plan]
    feed = {n: rand(20 + k, *shape) for k, (n, shape) in
            enumerate(sorted(tm._feed_shapes.items()))}
    run_both(j, t, feed)
    assert {k: tm.fusion_stats[k] for k in STAT_KEYS} == \
        {k: jm.fusion_stats[k] for k in STAT_KEYS}


# ------------------------------------------------------- BERT, 2 layers
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
BERT_STATS = {"matched": {"norm_linear": 1, "residual_norm": 4,
                          "linear_act": 2},
              "rewritten": {"residual_norm": 4, "linear_act": 2},
              "rejected": {"norm_linear": 1}}


def bert_programs(shape):
    """BertModel (the JAX package's weights in both) built under each
    package's guard over ``data("ids", shape, "int64")``, fetching the
    sequence output and the pooled output."""
    jm = jbert.BertModel(jbert.BertConfig(**BERT))
    state = seeded_state(jm)
    jm.set_state_dict(state)
    tm = tbert.BertModel(tbert.BertConfig(**BERT))
    load_jax_layer_state(tm, state)
    out = []
    for pkg, model in ((jp, jm), (tp, tm)):
        model.eval()
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            ids = pkg.static.data("ids", shape, "int64")
            out.append((main, list(model(ids))))
    return out


@pytest.mark.parametrize("fusion", [False, True], ids=["unfused", "fused"])
def test_bert_program_matches_jax_program(fusion, request):
    if fusion:
        request.getfixturevalue("fused")
    j, t = bert_programs([3, 8])
    ids = np.random.RandomState(9).randint(0, BERT["vocab_size"], (3, 8))
    run_both(j, t, {"ids": ids})
    if fusion:
        assert {k: t[0].fusion_stats[k] for k in STAT_KEYS} == \
            {k: j[0].fusion_stats[k] for k in STAT_KEYS} == BERT_STATS
    else:
        assert t[0].fusion_stats is None and j[0].fusion_stats is None


def test_bert_built_at_batch_1_raises_at_batch_3():
    """Over ``[None, 8]`` the example batch is 1 and attention's reshape
    takes it in: a feed of batch 3 raises in both packages (JAX:
    ``paddle_tpu/ops/manipulation.py:53``, ROADMAP Queue 3) and the port
    returns nothing."""
    (jm, jf), (tm, tf) = bert_programs([None, 8])
    ids = np.random.RandomState(10).randint(0, BERT["vocab_size"], (3, 8))
    with pytest.raises(Exception, match="reshape"):
        jp.static.Executor().run(jm, {"ids": ids}, jf)
    with pytest.raises(RuntimeError):
        tp.static.Executor().run(tm, {"ids": ids}, tf)
    one = ids[:1]
    run_both((jm, jf), (tm, tf), {"ids": one})
