"""SOT partial-frame capture (``paddle_tpu_torch/jit/sot``) held against
the JAX package's (``paddle_tpu/jit/sot``) on the same numpy inputs and
the same weights: every case of ``tests/test_sot.py`` run on both
packages (the lazy segments under ``sot.capture``, ``to_static`` with
``full_graph=False`` through a host read, the steady-state bypass and its
guards), control flow inside a capture with its gradients, a segment that
fuses (the fusion pass's stats on the segment equal to the JAX
``fuse_sot_nodes``'s, the result within a few fp32 units of the unfused
one), the slice's frame (a 2-layer BERT whose forward reads
``isfinite(seq).all()`` on the host between the encoder and the heads)
with its gradients, batch norm's running statistics through a first
call's break (against both packages' eager runs), and the metrics'
names and labels.

Outputs agree within 1e-6 in fp32 (the BERT frame's logits, loss and
gradients within 1e-5), and the ``sot_stats`` dicts exactly, call by
call. The port runs on the CPU, on its plain versions.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.compile import fusion as jfusion
from paddle_tpu.jit import sot as jsot
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.lazy_init import LazyGuard
from paddle_tpu.observability.metrics import REGISTRY as JREG
from paddle_tpu.ops.pallas import fused_ops as JK
from paddle_tpu_torch.compile import fusion as tfusion
from paddle_tpu_torch.jit import sot as tsot
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import load_jax_layer_state
from paddle_tpu_torch.observability.metrics import REGISTRY as TREG
from test_torch_bert import seeded_state
from torch_vision_zoo import lazy_jax

TOL = 1e-6
BERT_TOL = 1e-5
PKGS = ((jp, jsot), (tp, tsot))


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _np(x):
    return np.asarray(x.numpy())


def both(case):
    """``case(pkg, sot)`` on each package; returns (JAX's, the port's)."""
    return [case(pkg, sot) for pkg, sot in PKGS]


def assert_runs(runs):
    """Two packages' call lists of (outputs, stats): stats equal, outputs
    within TOL."""
    j, t = runs
    assert len(j) == len(t)
    for (jo, js), (to, ts) in zip(j, t):
        assert ts == js
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=0)


def _quiet(fn, *a):
    """A call whose first run warns of the graph break."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn(*a)
    return out, [str(w.message) for w in seen]


# ----------------------------------------------------- lazy segments
def _lazy_materialized(pkg, sot):
    x = pkg.to_tensor(np.random.RandomState(0).randn(4, 4).astype(
        np.float32))
    with sot.capture() as cap:
        y = pkg.ops.tanh(x)
        z = y + 1.0
        assert isinstance(z._data, sot.LazyArray)
        assert z._data._value is None
        assert z.shape == [4, 4]            # abstract metadata
        got = z.numpy()                     # the break: flushes
        assert z._data is not None
    return [([got], dict(cap.stats))]


def _lazy_two_segments(pkg, sot):
    x = pkg.to_tensor(np.random.RandomState(1).randn(4, 4).astype(
        np.float32))
    with sot.capture() as cap:
        y = pkg.ops.tanh(x)
        s = float(y.numpy().sum())          # graph break
        z = pkg.ops.exp(y) * s
        got = z.numpy()
    return [([got], dict(cap.stats))]


def _lazy_cache_reuse(pkg, sot):
    cache = {}
    x = pkg.to_tensor(np.random.RandomState(2).randn(4, 4).astype(
        np.float32))

    def run():
        with sot.capture(cache) as cap:
            y = pkg.ops.tanh(x)
            a = y.numpy()
            z = pkg.ops.exp(y)
            b = z.numpy()
        return [a, b], dict(cap.stats)
    return [run(), run()]


def _lazy_nonzero(pkg, sot):
    x = pkg.to_tensor(np.asarray([1.0, 0.0, 2.0, 0.0], np.float32))
    with sot.capture() as cap:
        y = x * 2.0
        nz = pkg.ops.nonzero(y)             # shape depends on data
        out = nz.numpy()
    np.testing.assert_array_equal(out.ravel(), [0, 2])
    return [([out.ravel()], dict(cap.stats))]


@pytest.mark.parametrize("case", [_lazy_materialized, _lazy_two_segments,
                                  _lazy_cache_reuse, _lazy_nonzero],
                         ids=["materialized", "two_segments", "cache_reuse",
                              "nonzero_breaks"])
def test_lazy_segments(case):
    runs = both(case)
    assert_runs(runs)
    if case is _lazy_cache_reuse:
        assert [s for _o, s in runs[1]] == [{"segments": 2, "compiled": 2},
                                            {"segments": 2, "compiled": 0}]


# ---------------------------------------------------------- to_static
def _sync_fn(pkg):
    w = pkg.to_tensor(
        np.random.RandomState(0).randn(8, 8).astype(np.float32) * 0.3)

    def fn(x):
        y = pkg.ops.tanh(pkg.ops.matmul(x, w))
        s = float(y.numpy().sum())          # mid-frame host sync
        if s > 1e9:                         # data-dependent Python flow
            y = y * 0.0
        return pkg.ops.exp(y) + s
    return fn


def _two_calls(pkg, sot):
    fn = _sync_fn(pkg)
    st = pkg.jit.to_static(fn, full_graph=False)
    x = pkg.to_tensor(np.random.RandomState(1).randn(2, 8).astype(
        np.float32))
    out, said = _quiet(st, x)
    assert any("SOT partial-frame" in m for m in said), said
    calls = [([_np(out), _np(fn(x))], dict(st.sot_stats))]
    calls.append(([_np(st(x))], dict(st.sot_stats)))
    return calls


def _new_shape(pkg, sot):
    st = pkg.jit.to_static(_sync_fn(pkg), full_graph=False)
    x1 = pkg.to_tensor(np.random.RandomState(2).randn(2, 8).astype(
        np.float32))
    x2 = pkg.to_tensor(np.random.RandomState(3).randn(5, 8).astype(
        np.float32))
    calls = []
    for x in (x1, x2, x2):
        out, _ = _quiet(st, x)
        calls.append(([_np(out)], dict(st.sot_stats)))
    return calls


def _full_graph_kept(pkg, sot):
    calls = []

    def fn(x):
        calls.append(1)
        return pkg.ops.tanh(x) * 2.0
    st = pkg.jit.to_static(fn, full_graph=False)
    x = pkg.to_tensor(np.random.RandomState(4).randn(3, 3).astype(
        np.float32))
    a, b = st(x), st(x)
    assert st.sot_stats is None             # never broke
    assert len(calls) == 1                  # recorded once, then replayed
    return [([_np(a), _np(b)], None)]


def _output_reused(pkg, sot):
    st = pkg.jit.to_static(_sync_fn(pkg), full_graph=False)
    x = pkg.to_tensor(np.random.RandomState(5).randn(2, 8).astype(
        np.float32))
    out, _ = _quiet(st, x)
    more = pkg.ops.mean(out * 2.0)          # a plain eager op after it
    return [([_np(more)], dict(st.sot_stats))]


def _training_through_break(pkg, sot):
    rng = np.random.RandomState(3)
    w = pkg.to_tensor(rng.randn(4, 4).astype(np.float32) * 0.5)
    w.stop_gradient = False
    x = pkg.to_tensor(rng.randn(2, 4).astype(np.float32))

    def loss_fn():
        y = pkg.ops.tanh(pkg.ops.matmul(x, w))
        _ = y.numpy()                       # break
        return pkg.ops.mean(pkg.ops.exp(y))
    with sot.capture() as cap:
        loss = loss_fn()
    loss.backward()
    got = _np(w.grad)
    w.clear_grad()
    loss_fn().backward()
    np.testing.assert_allclose(got, _np(w.grad), atol=TOL, rtol=0)
    return [([_np(loss), got], dict(cap.stats))]


@pytest.mark.parametrize("case", [_two_calls, _new_shape, _full_graph_kept,
                                  _output_reused, _training_through_break],
                         ids=["two_compiled_segments", "new_shape_recompiles",
                              "full_graph_signatures_kept",
                              "output_in_later_eager_ops",
                              "training_through_break"])
def test_to_static_sot(case):
    runs = both(case)
    assert_runs(runs)
    if case is _two_calls:
        assert [s for _o, s in runs[1]] == [
            {"segments": 2, "compiled": 2, "bypassed": False},
            {"segments": 2, "compiled": 0, "bypassed": False}]


def _bn_net(pkg, state):
    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bn = pkg.nn.BatchNorm1D(8)
            self.fc = pkg.nn.Linear(8, 4)

        def forward(self, x):
            h = self.bn(x)
            if float(h.abs().sum().numpy()) < 0:    # host read: SOT
                h = -h
            return self.fc(h)

    net = Net()
    net.set_state_dict(state)
    return net


def test_batch_norm_before_break_updates_statistics_once():
    """Batch norm in training mode before a host read. On the first call
    the recording runs up to the break, and the call then runs again
    under SOT; the running statistics still move once a call. Outputs
    and statistics as the port's eager run and the JAX package's eager
    run (the JAX SOT raises on a deferred batch norm in training mode:
    its lowering multiplies a placeholder on the host)."""
    jnet, eager, net = _bn_nets()
    st = tp.jit.to_static(net, full_graph=False)
    _assert_bn_once(st, st.forward, jnet, eager, net)


def test_batch_norm_through_a_closure_updates_statistics_once():
    """As above, with the batch-norm Layer reached through the function's
    closure: neither bound to the function nor an argument of it."""
    jnet, eager, net = _bn_nets()
    st = tp.jit.to_static(lambda x: net(x), full_graph=False)
    _assert_bn_once(st, st, jnet, eager, net)


def _bn_nets():
    """The JAX net, the port's eager twin and the port's net to capture,
    on one seeded state."""
    rng = np.random.RandomState(8)
    state = {k: (rng.rand(*v.shape) + 0.5 if k.endswith("_variance")
                 else rng.randn(*v.shape) * 0.3).astype(np.float32)
             for k, v in _bn_net(tp, {}).state_dict().items()}
    return _bn_net(jp, state), _bn_net(tp, state), _bn_net(tp, state)


def _assert_bn_once(st, sf, jnet, eager, net):
    stats = []
    for seed in (9, 10):
        jx, x = _x(jp, seed), _x(tp, seed)
        got, _ = _quiet(st, x)
        stats.append(dict(sf.sot_stats))
        for a, e, j in ((got, eager(x), jnet(jx)),
                        (net.bn._mean, eager.bn._mean, jnet.bn._mean),
                        (net.bn._variance, eager.bn._variance,
                         jnet.bn._variance)):
            np.testing.assert_allclose(_np(a), _np(e), atol=TOL, rtol=0)
            np.testing.assert_allclose(_np(a), _np(j), atol=TOL, rtol=0)
    assert stats == [
        {"segments": 2, "compiled": 2, "bypassed": False},
        {"segments": 2, "compiled": 0, "bypassed": False}]


# --------------------------------------------------- steady-state bypass
def _net(pkg, grad=False):
    class Net(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg.nn.Linear(8, 8)
            self.gain = 2.0

        def forward(self, x):
            s = float(pkg.ops.mean(x).numpy())   # input-only break
            y = pkg.ops.tanh(self.fc(x))
            if s > 1e9:                          # glue control flow
                y = y * 0.0
            return pkg.ops.exp(y) * self.gain

    net = Net()
    rng = np.random.RandomState(21)
    net.set_state_dict({k: rng.randn(*v.shape).astype(np.float32) * 0.3
                        for k, v in net.state_dict().items()})
    for p in net.parameters():
        p.stop_gradient = not grad
    return net


def _x(pkg, seed, shape=(4, 8)):
    return pkg.to_tensor(np.random.RandomState(seed).randn(*shape).astype(
        np.float32))


def _calls(pkg, st, xs, ref):
    out = []
    for x in xs:
        got, _ = _quiet(st, x)
        out.append(([_np(got), _np(ref(x))], dict(st.sot_stats)))
    return out


def _third_bypasses(pkg, sot):
    net = _net(pkg)
    st = pkg.jit.to_static(net.forward, full_graph=False)
    x = _x(pkg, 2)
    return _calls(pkg, st, [x, x, x], net.forward)


def _reads_params_live(pkg, sot):
    net = _net(pkg)
    st = pkg.jit.to_static(net.forward, full_graph=False)
    x = _x(pkg, 4)
    calls = _calls(pkg, st, [x, x, x], net.forward)
    w = net.fc.weight
    w._swap_payload(w._data * 0.5)          # the journal re-reads it
    return calls + _calls(pkg, st, [x], net.forward)


def _break_value_guard(pkg, sot):
    net = _net(pkg)
    st = pkg.jit.to_static(net.forward, full_graph=False)
    x1 = _x(pkg, 5)
    # same shapes, other values: the break scalar changes, the guard
    # misses, the frame replays
    return _calls(pkg, st, [x1, x1, x1, _x(pkg, 6)], net.forward)


def _object_attr_guard(pkg, sot):
    net = _net(pkg)
    st = pkg.jit.to_static(net.forward, full_graph=False)
    x = _x(pkg, 7)
    calls = _calls(pkg, st, [x, x, x], net.forward)
    net.gain = 3.0                          # the frame guard misses
    return calls + _calls(pkg, st, [x], net.forward)


def _grad_frames_replay(pkg, sot):
    net = _net(pkg, grad=True)              # outputs carry autograd
    st = pkg.jit.to_static(net.forward, full_graph=False)
    x = _x(pkg, 8)
    return _calls(pkg, st, [x, x, x], net.forward)


def _single_segment_branch(pkg, sot):
    w = pkg.to_tensor(
        np.random.RandomState(31).randn(8, 8).astype(np.float32) * 0.3)

    def fn(x):
        y = pkg.ops.tanh(pkg.ops.matmul(x, w))
        s = float(pkg.ops.mean(y).numpy())
        if s > 0:
            return y
        return y * 0.0

    st = pkg.jit.to_static(fn, full_graph=False)
    xp = pkg.to_tensor(np.full((2, 8), 0.5, np.float32))
    xn = pkg.to_tensor(np.full((2, 8), -0.5, np.float32))
    # a positive mean three times (stable), then a negative one: the
    # branch must flip, not replay stale
    return _calls(pkg, st, [xp, xp, xp, xn], fn)


def _ndarray_inputs(pkg, sot):
    net = _net(pkg)
    st = pkg.jit.to_static(net.forward, full_graph=False)
    a = np.random.RandomState(8).randn(4, 8).astype(np.float32)
    b = np.random.RandomState(9).randn(4, 8).astype(np.float32)
    return _calls(pkg, st, [a, a, b],
                  lambda arr: net.forward(pkg.to_tensor(arr)))


BYPASS = {"third_call_bypasses": _third_bypasses,
          "reads_parameters_live": _reads_params_live,
          "break_value_guard_falls_back": _break_value_guard,
          "object_attr_guard_invalidates": _object_attr_guard,
          "grad_frames_stay_on_replay": _grad_frames_replay,
          "single_segment_branch_guarded": _single_segment_branch,
          "ndarray_inputs_never_bypass": _ndarray_inputs}


@pytest.mark.parametrize("name", sorted(BYPASS))
def test_steady_state_bypass(name):
    runs = both(BYPASS[name])
    assert_runs(runs)
    bypassed = [s["bypassed"] for _o, s in runs[1]]
    want = {"third_call_bypasses": [False, False, True],
            "reads_parameters_live": [False, False, True, True],
            "break_value_guard_falls_back": [False, False, True, False],
            "object_attr_guard_invalidates": [False, False, True, False],
            "grad_frames_stay_on_replay": [False, False, False],
            "ndarray_inputs_never_bypass": [False, False, False]}
    if name in want:
        assert bypassed == want[name]


# ------------------------------------------------ control flow in SOT
def _cond_in_capture(pkg, sot):
    nn = pkg.static.nn
    rng = np.random.RandomState(0)
    w = pkg.to_tensor(rng.randn(4).astype(np.float32))
    w.stop_gradient = False
    x = pkg.to_tensor(np.ones(4, np.float32))

    def loss_fn():
        loss = (x * w).sum()
        return nn.cond(loss > 0.0, lambda: loss * 2.0, lambda: loss * 0.5)

    with sot.capture() as cap:
        out = loss_fn()
    out.backward()
    g_sot = _np(w.grad)
    w.clear_grad()
    loss_fn().backward()
    np.testing.assert_allclose(g_sot, _np(w.grad), atol=TOL, rtol=0)
    return [([_np(out), g_sot], dict(cap.stats))]


def _while_in_capture(pkg, sot):
    nn = pkg.static.nn
    x = pkg.to_tensor(np.array([2.0], dtype=np.float32))

    def f():
        i, v = nn.while_loop(lambda i, v: i < 3,
                             lambda i, v: [i + 1, v * 2.0],
                             [pkg.to_tensor(np.int32(0)), x])
        return v.sum()

    with sot.capture() as cap:
        out = f()
    np.testing.assert_allclose(_np(out), 16.0)
    return [([_np(out)], dict(cap.stats))]


@pytest.mark.parametrize("case", [_cond_in_capture, _while_in_capture],
                         ids=["cond_with_grad", "while_loop"])
def test_control_flow_inside_capture(case):
    assert_runs(both(case))


# --------------------------------------------------- segments that fuse
@pytest.fixture
def fusion_on():
    old = JK.INTERPRET
    JK.INTERPRET = True
    yield
    JK.INTERPRET = old
    jp.set_flags({"FLAGS_enable_fusion": False})
    tp.set_flags({"FLAGS_enable_fusion": False})


def _as_jax_nodes(nodes):
    """The port's segment nodes as the JAX package's node tuples."""
    return [(n.name, n.fn, n.in_ids, len(n.out_ids), "", n.attrs,
             (n.in_shapes, n.out_shapes)) for n in nodes]


def test_sot_segments_fuse_with_parity(fusion_on, monkeypatch):
    """A norm -> linear -> gelu chain in the segment before a host read:
    the pass rewrites it on both packages with the same stats (and the
    JAX ``fuse_sot_nodes`` gives them on the port's own segment), and the
    fused frame gives the unfused frame's values. The layers are frozen:
    in a frame that records gradients the JAX tape holds every
    intermediate of the segment, which makes each a segment output and
    rejects the chain; the port's segment outputs are the values Python
    still holds."""
    rng = np.random.RandomState(0)
    state = None
    results = []
    for pkg, fmod in ((jp, jfusion), (tp, tfusion)):
        seen = []
        real = fmod.fuse_sot_nodes

        def spy(nodes, out_refs, _real=real, _seen=seen):
            plan, stats = _real(nodes, out_refs)
            _seen.append((stats, nodes, out_refs))
            return plan, stats
        monkeypatch.setattr(fmod, "fuse_sot_nodes", spy)
        nn, F = pkg.nn, pkg.nn.functional
        ln, fc = nn.LayerNorm(32), nn.Linear(32, 64)
        if state is None:
            state = {"ln": {k: (1.0 + 0.1 * rng.randn(*v.shape)) if
                            k == "weight" else 0.1 * rng.randn(*v.shape)
                            for k, v in ln.state_dict().items()},
                     "fc": {k: rng.randn(*v.shape) / 6.0
                            for k, v in fc.state_dict().items()}}
        ln.set_state_dict({k: v.astype(np.float32)
                           for k, v in state["ln"].items()})
        fc.set_state_dict({k: v.astype(np.float32)
                           for k, v in state["fc"].items()})
        for p in ln.parameters() + fc.parameters():
            p.stop_gradient = True

        def f(x):
            h = F.gelu(fc(ln(x)))
            if float(h.sum().numpy()) > -1e9:     # host read: SOT
                h = h * 2.0
            return h

        x = pkg.to_tensor(np.random.RandomState(1).randn(4, 32).astype(
            np.float32))
        pkg.set_flags({"FLAGS_enable_fusion": True})
        st = pkg.jit.to_static(f, full_graph=False)
        out, _ = _quiet(st, x)
        stats = dict(st.sot_stats)
        pkg.set_flags({"FLAGS_enable_fusion": False})
        ref = f(x)
        # the fused op against the ops one at a time: a few fp32 units
        # apart in either package (the sums run in another order)
        np.testing.assert_allclose(_np(out), _np(ref), atol=TOL, rtol=TOL)
        results.append((seen, stats, _np(out)))
    (jseen, jstats, jout), (tseen, tstats, tout) = results
    assert tstats == jstats
    assert tstats["fusion_rewritten"] >= 1
    keys = ("matched", "rewritten", "rejected", "ops_before", "ops_after")
    want = [{k: s[k] for k in keys} for s, _n, _r in jseen]
    assert [{k: s[k] for k in keys} for s, _n, _r in tseen] == want
    on_port_segments = [jfusion.fuse_sot_nodes(_as_jax_nodes(n), r)[1]
                        for _s, n, r in tseen]
    assert [{k: s[k] for k in keys} for s in on_port_segments] == want
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)


# --------------------------------------------- the slice's BERT frame
BERT = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, fused_loss=True)
BB, BS = 2, 16


def _guarded(pkg, module):
    """BertForPretraining whose forward reads the encoder output's
    finiteness on the host between the encoder and the heads."""
    F = pkg.nn.functional

    class Guarded(module.BertForPretraining):
        def forward(self, input_ids, masked_lm_labels=None):
            seq, pooled = self.bert(input_ids)
            if not bool(pkg.isfinite(seq).all()):
                raise FloatingPointError("non-finite encoder output")
            h = self.mlm_norm(F.gelu(self.mlm_dense(seq), approximate=True))
            w = self.bert.embeddings.word_embeddings.weight
            nsp_logits = self.nsp(pooled)
            if masked_lm_labels is None:
                return pkg.matmul(h, w, transpose_y=True), nsp_logits
            loss = F.fused_linear_cross_entropy(
                pkg.reshape(h, [-1, self.bert.cfg.hidden_size]), w,
                pkg.reshape(masked_lm_labels, [-1]), transpose_y=True,
                ignore_index=-100)
            return nsp_logits, loss
    return Guarded


def test_bert_frame_with_host_read_matches_jax():
    with LazyGuard():
        state = seeded_state(jbert.BertForPretraining(jbert.BertConfig(
            **BERT)))
    jm = lazy_jax(lambda: _guarded(jp, jbert)(jbert.BertConfig(**BERT)),
                  lambda j: state)
    tm = _guarded(tp, tbert)(tbert.BertConfig(**BERT))
    load_jax_layer_state(tm, state)
    ids = np.random.RandomState(7).randint(0, BERT["vocab_size"], (BB, BS))
    got = []
    for pkg, model in ((jp, jm), (tp, tm)):
        st = pkg.jit.to_static(model, full_graph=False)
        t = pkg.to_tensor(ids)
        logits, _ = _quiet(st, t)
        stats = [dict(st.forward.sot_stats)]
        nsp, loss = st(t, masked_lm_labels=t)
        stats.append(dict(st.forward.sot_stats))
        loss.backward()
        grads = {n: _np(p.grad) for n, p in model.named_parameters()
                 if p.grad is not None}
        got.append(([_np(o) for o in logits] + [_np(nsp)], float(_np(loss)),
                    grads, stats))
    (jl, jloss, jg, js), (tl, tloss, tg, ts) = got
    assert ts == js
    assert [s["segments"] for s in ts] == [2, 2]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, atol=BERT_TOL, rtol=0)
    assert abs(tloss - jloss) <= BERT_TOL
    assert set(tg) == {n for n, g in jg.items() if np.any(g)} | (
        set(tg) & set(jg))
    for name, g in tg.items():
        np.testing.assert_allclose(g, jg[name], atol=BERT_TOL, rtol=0,
                                   err_msg=name)


# ------------------------------------- the port's own eager semantics
def _frame_with_draws(x):
    """Dropout deferred into segment 1; a random creation op, which
    flushes it before it draws; dropout in segment 2, which a host read
    ends; dropout again in segment 3."""
    F = tp.nn.functional
    y = F.dropout(tp.tanh(x), p=0.5)
    z = tp.randn([4, 8]) + F.dropout(y, p=0.5)
    s = float(z.sum())
    return z * s + F.dropout(y, p=0.5)


def test_random_draws_match_eager():
    """Deferred draws run at the flush, in op order, and a draw outside
    the dispatcher flushes first: an SOT call (the first, whose recording
    draws before the break, and a replay) draws what eager draws."""
    x = tp.to_tensor(np.random.RandomState(0).randn(4, 8).astype(
        np.float32))
    tp.seed(5)
    want = _np(_frame_with_draws(x))
    st = tp.jit.to_static(_frame_with_draws, full_graph=False)
    for _ in range(2):
        tp.seed(5)
        got, _ = _quiet(st, x)
        np.testing.assert_array_equal(_np(got), want)
    assert st.sot_stats["segments"] == 3


def _modes_frame(x, w):
    from paddle_tpu_torch import amp
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        y = tp.matmul(x, w)                 # deferred under O1
    with tp.no_grad():
        z = y * 2.0                         # deferred without grad
    y = y.astype("float32")
    y.add_(tp.to_tensor(1.0))               # in place on a placeholder
    y[0] = 5.0
    if float(z.astype("float32").mean()) > 1e9:     # the break
        y = y * 0.0
    return (y * y).sum(), z


def test_amp_grad_mode_and_in_place_follow_eager():
    """Each deferred op runs under the amp state and grad mode it was
    deferred under, and in-place ops on a placeholder become ops of the
    segment: values, dtypes, stop_gradient and the gradient as eager."""
    rng = np.random.RandomState(1)
    x = tp.to_tensor(rng.randn(4, 8).astype(np.float32))
    w = tp.to_tensor(rng.randn(8, 8).astype(np.float32))
    w.stop_gradient = False
    want = _modes_frame(x, w)
    want[0].backward()
    want_g = _np(w.grad)
    w.clear_grad()
    with tsot.capture() as cap:
        got = _modes_frame(x, w)
    got[0].backward()
    assert cap.stats["segments"] == 2
    for g, e in zip(got, want):
        assert (g.dtype, g.stop_gradient) == (e.dtype, e.stop_gradient)
        np.testing.assert_array_equal(_np(g), _np(e))
    np.testing.assert_array_equal(_np(w.grad), want_g)


def test_flush_drops_values_after_their_last_read():
    """A segment's plan drops each value after its last read, as eager
    code lets go of a temporary, and keeps the values live at the
    flush: a chain of three ops keeps only its end."""
    x = tp.to_tensor(np.ones((4, 4), np.float32))
    with tsot.capture() as cap:
        end = tp.exp(tp.tanh(x)) * 2.0
        end.numpy()
    (plan,) = cap.cache.values()
    assert [st.name for st in plan.steps] == ["tanh", "exp", "multiply"]
    assert plan.out_ids == [("n", 2, 0)]
    assert plan._free == [[], [("n", 0, 0)], [("n", 1, 0)]]


# ------------------------------------------------------------ metrics
@pytest.mark.parametrize("name", ["paddle_tpu_sot_frame_total",
                                  "paddle_tpu_sot_segment_cache_total",
                                  "paddle_tpu_sot_segment_compile_seconds"])
def test_metric_names_and_labels(name):
    j, t = JREG.get(name), TREG.get(name)
    assert j is not None and t is not None
    assert (t.kind, t.labelnames) == (j.kind, j.labelnames)
