"""In-graph control flow of the port (``static.nn.cond``, ``while_loop``,
``case``, ``switch_case``) held against the JAX package: the cases of
``tests/test_control_flow.py`` that need no SOT and no
``static.Program``, each run on both packages over the same numpy
inputs, outputs and gradients compared (to 1e-6), plus the port's own
contract under ``to_static``: one recorded op a construct, and a replay
that takes the other branch or another trip count."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def t(pkg, x, dtype=np.float32, grad=False):
    out = pkg.to_tensor(np.asarray(x, dtype=dtype))
    if grad:
        out.stop_gradient = False
    return out


def both(case):
    """``case(pkg)`` -> a list of numpy arrays, on each package; they
    agree to TOL."""
    got_j, got_t = case(jp), case(tp)
    assert len(got_j) == len(got_t)
    for a, b in zip(got_j, got_t):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), **TOL)
    return got_t


def scalars(arrays):
    return [float(np.ravel(a)[0]) for a in arrays]


def ops_of(static):
    """The op names of a port StaticFunction's only recording."""
    (program, _), = static._programs.values()
    return [st.name for st in program.steps]


class TestSurface:
    def test_public_surface_and_registry(self):
        from paddle_tpu_torch.ops.registry import OPS
        for name in ("cond", "while_loop", "case", "switch_case"):
            assert hasattr(tp.static.nn, name)
        for name in ("conditional_block", "while_loop", "case",
                     "switch_case"):
            assert OPS[name].category == "control_flow"
        assert not OPS["while_loop"].differentiable


class TestCondEager:
    def test_branch_selection(self):
        def case(p):
            x = t(p, [3.0])
            nn = p.static.nn
            return [nn.cond(t(p, True, np.bool_), lambda: x * 2,
                            lambda: x * 3).numpy(),
                    nn.cond(t(p, False, np.bool_), lambda: x * 2,
                            lambda: x * 3).numpy(),
                    nn.cond(t(p, 2, np.int32), lambda: x + 1,
                            lambda: x - 1).numpy()]
        hi, lo, pos = both(case)
        np.testing.assert_allclose(hi, [6.0])
        np.testing.assert_allclose(lo, [9.0])
        np.testing.assert_allclose(pos, [4.0])

    def test_one_sided_eager(self):
        hits = []
        tp.static.nn.cond(t(tp, False, np.bool_), lambda: hits.append("t"))
        assert hits == []
        tp.static.nn.cond(t(tp, True, np.bool_), lambda: hits.append("t"))
        assert hits == ["t"]

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_nonscalar_pred_raises(self, pkg):
        with pytest.raises(ValueError, match="scalar"):
            pkg.static.nn.cond(t(pkg, [True, False], np.bool_),
                               lambda: t(pkg, 1.0), lambda: t(pkg, 2.0))

    def test_grad_through_taken_branch(self):
        def case(p):
            out = []
            for xval in (1.0, 10.0):
                w = t(p, [2.0], grad=True)
                x = t(p, [xval])
                loss = (x * w).sum()
                clipped = p.static.nn.cond(loss > 3.0,
                                           lambda: loss * 0.0 + 3.0,
                                           lambda: loss)
                clipped.backward()
                out += [clipped.numpy(), w.grad.numpy()]
            return out
        _, g1, _, g10 = both(case)
        np.testing.assert_allclose(g1, [1.0])
        np.testing.assert_allclose(g10, [0.0])

    def test_pytree_output(self):
        def case(p):
            x = t(p, [1.0, 2.0])
            out = p.static.nn.cond(t(p, True, np.bool_),
                                   lambda: {"a": x + 1, "b": [x * 2, x * 3]},
                                   lambda: {"a": x - 1, "b": [x, x]})
            return [out["a"].numpy(), out["b"][0].numpy(),
                    out["b"][1].numpy()]
        both(case)


class TestCondCompiled:
    def test_output_parity_both_branches_and_replay(self):
        """Recorded on one branch, replayed on the other: one op."""
        def case(p):
            w = t(p, [2.0])

            def f(x):
                loss = (x * w).sum()
                return p.static.nn.cond(loss > 3.0, lambda: loss * 0.0 + 3.0,
                                        lambda: loss)
            st = p.jit.to_static(f, full_graph=True)
            out = [st(t(p, v)).numpy() for v in ([1.0], [10.0], [1.0])]
            assert st.graph_break_reason is None
            if p is tp:
                assert ops_of(st).count("conditional_block") == 1
                assert "subtract" not in ops_of(st)
            return out
        assert scalars(both(case)) == [2.0, 3.0, 2.0]

    def test_grad_parity_both_branches(self):
        """The replayed op's gradient (torch autograd through the branch
        that ran) against the JAX compiled gradient."""
        def case(p):
            w = t(p, [2.0], grad=True)
            out = []
            if p is jp:
                @p.jit.to_static(full_graph=True)
                def f(x):
                    loss = (x * w).sum()
                    c = p.static.nn.cond(loss > 3.0, lambda: loss * 0.0 + 3.0,
                                         lambda: loss)
                    g, = p.autograd.grad([c], [w])
                    return c, g
                for v in ([1.0], [10.0], [1.0]):
                    c, g = f(t(p, v))
                    out += [c.numpy(), g.numpy()]
                return out

            def f(x):
                loss = (x * w).sum()
                return p.static.nn.cond(loss > 3.0, lambda: loss * 0.0 + 3.0,
                                        lambda: loss)
            st = p.jit.to_static(f, full_graph=True)
            for v in ([1.0], [10.0], [1.0]):
                c = st(t(p, v))
                g, = p.autograd.grad([c], [w])
                out += [c.numpy(), g.numpy()]
            return out
        got = both(case)
        np.testing.assert_allclose(got[1], [1.0])
        np.testing.assert_allclose(got[3], [0.0])

    def test_passthrough_branch_is_operand_not_constant(self):
        def case(p):
            x = t(p, [1.0, 2.0], grad=True)
            y = t(p, [10.0, 20.0], grad=True)
            out = []
            if p is jp:
                @p.jit.to_static(full_graph=True)
                def f(q):
                    o = p.static.nn.cond(q.sum() > 0, lambda: x, lambda: y)
                    gx, gy = p.autograd.grad([o.sum()], [x, y])
                    return o, gx, gy
                for v in ([1.0], [-1.0]):
                    out += [a.numpy() for a in f(t(p, v))]
                return out
            st = p.jit.to_static(
                lambda q: p.static.nn.cond(q.sum() > 0, lambda: x,
                                           lambda: y), full_graph=True)
            for v in ([1.0], [-1.0]):
                o = st(t(p, v))
                gx, gy = p.autograd.grad([o.sum()], [x, y],
                                         allow_unused=True)
                out += [o.numpy()] + [np.zeros(2) if g is None else g.numpy()
                                      for g in (gx, gy)]
            return out
        o1, gx1, gy1, o2, gx2, gy2 = both(case)
        np.testing.assert_allclose(gx1, [1.0, 1.0])
        np.testing.assert_allclose(gy2, [1.0, 1.0])

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_one_sided_capture_raises(self, pkg):
        @pkg.jit.to_static(full_graph=True)
        def f(x):
            return pkg.static.nn.cond(x.sum() > 0, lambda: x * 2)

        with pytest.raises(Exception, match="true_fn and false_fn"):
            f(t(pkg, [1.0]))

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_mismatched_structures_raise(self, pkg):
        @pkg.jit.to_static(full_graph=True)
        def f(x):
            return pkg.static.nn.cond(x.sum() > 0, lambda: (x, x), lambda: x)

        with pytest.raises(Exception, match="different structures"):
            f(t(pkg, [1.0]))

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_bad_branch_output_raises(self, pkg):
        @pkg.jit.to_static(full_graph=True)
        def f(x):
            return pkg.static.nn.cond(x.sum() > 0, lambda: 1.0, lambda: 2.0)

        with pytest.raises(TypeError, match="must return Tensors"):
            f(t(pkg, [1.0]))

    def test_no_graph_break_full_graph_false(self):
        import warnings

        def case(p):
            w = t(p, [1.5])

            def f(x):
                s = (x * w).sum()
                return p.static.nn.cond(s > 0.0, lambda: s * 2.0,
                                        lambda: s * 0.5)
            st = p.jit.to_static(f, full_graph=False)
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                out = [st(t(p, [1.0, 2.0])).numpy(),
                       st(t(p, [-1.0, -2.0])).numpy()]
            assert st.graph_break_reason is None
            return out
        both(case)


class TestWhileLoop:
    def test_eager_basic_and_zero_trip(self):
        def case(p):
            nn = p.static.nn
            i, s = nn.while_loop(lambda i, s: i < 5,
                                 lambda i, s: [i + 1, s + 2.0],
                                 [t(p, 0, np.int32), t(p, 0.0)])
            i0, s0 = nn.while_loop(lambda i, s: i < 0,
                                   lambda i, s: [i + 1, s + 2.0],
                                   [t(p, 3, np.int32), t(p, 1.0)])
            return [i.numpy(), s.numpy(), i0.numpy(), s0.numpy()]
        assert scalars(both(case)) == [5, 10.0, 3, 1.0]

    def test_compiled_parity_and_replay_other_trip_count(self):
        def case(p):
            def f(n):
                _i, s2 = p.static.nn.while_loop(
                    lambda i, s: i < n, lambda i, s: [i + 1, s + 2.0],
                    [t(p, 0, np.int32), t(p, 0.0)])
                return s2
            st = p.jit.to_static(f, full_graph=True)
            out = [st(t(p, n, np.int32)).numpy() for n in (7, 2, 0, 11)]
            if p is tp:
                assert ops_of(st).count("while_loop") == 1
                assert "add" not in ops_of(st)
            return out
        assert scalars(both(case)) == [14.0, 4.0, 0.0, 22.0]

    def test_pytree_carried_state(self):
        def case(p):
            def f():
                state = {"i": t(p, 0, np.int32),
                         "acc": [t(p, 1.0), t(p, 0.0)]}

                def body(st):
                    return {"i": st["i"] + 1,
                            "acc": [st["acc"][0] * 2.0,
                                    st["acc"][1] + st["acc"][0]]}
                return p.static.nn.while_loop(lambda st: st["i"] < 4, body,
                                              [state])[0]
            out = []
            for res in (f(), p.jit.to_static(f, full_graph=True)()):
                out += [res["i"].numpy(), res["acc"][0].numpy(),
                        res["acc"][1].numpy()]
            return out
        got = both(case)
        assert scalars(got[:3]) == [4, 16.0, 15.0]

    def test_eager_grad_through_unrolled_tape(self):
        def case(p):
            w = t(p, 1.5, grad=True)
            _i, s = p.static.nn.while_loop(lambda i, s: i < 3,
                                           lambda i, s: [i + 1, s * w],
                                           [t(p, 0, np.int32), t(p, 1.0)])
            s.backward()
            return [s.numpy(), w.grad.numpy()]
        _, g = both(case)
        np.testing.assert_allclose(g, 3 * 1.5 ** 2, rtol=1e-6)

    def test_captured_outputs_are_forward_only(self):
        w = t(tp, 1.5, grad=True)

        def f(x):
            return tp.static.nn.while_loop(lambda i, s: i < 3,
                                           lambda i, s: [i + 1, s * w],
                                           [t(tp, 0, np.int32), x])[1]
        st = tp.jit.to_static(f, full_graph=True)
        for _ in range(2):
            out = st(t(tp, 1.0))
            assert out.stop_gradient
            np.testing.assert_allclose(out.numpy(), 1.5 ** 3, rtol=1e-6)

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_shape_invariance_error(self, pkg):
        @pkg.jit.to_static(full_graph=True)
        def f(x):
            return pkg.static.nn.while_loop(
                lambda v: v.sum() < 100.0,
                lambda v: [pkg.ops.concat([v, v])], [x])

        with pytest.raises(Exception, match="invariant|changes"):
            f(t(pkg, [1.0]))

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_bad_cond_error(self, pkg):
        @pkg.jit.to_static(full_graph=True)
        def f(x):
            return pkg.static.nn.while_loop(lambda v: v < 5.0,
                                            lambda v: [v + 1], [x])

        with pytest.raises(Exception, match="scalar"):
            f(t(pkg, [1.0, 2.0]))

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_loop_vars_type_error(self, pkg):
        with pytest.raises(TypeError):
            pkg.static.nn.while_loop(lambda i: i < 2, lambda i: i + 1,
                                     t(pkg, 0, np.int32))


class TestCaseSwitch:
    def test_case_eager_and_default(self):
        def case(p):
            x = t(p, [1.0])
            nn = p.static.nn
            f_, t_ = t(p, False, np.bool_), t(p, True, np.bool_)
            return [nn.case([(f_, lambda: x * 0), (t_, lambda: x * 5)],
                            default=lambda: x * 9).numpy(),
                    nn.case([(f_, lambda: x * 0), (f_, lambda: x * 5)],
                            default=lambda: x * 9).numpy(),
                    nn.case([(f_, lambda: x * 0),
                             (f_, lambda: x * 5)]).numpy()]
        assert scalars(both(case)) == [5.0, 9.0, 5.0]

    def test_case_compiled_parity_and_replay(self):
        def case(p):
            def f(a):
                s = a.sum()
                return p.static.nn.case(
                    [(s > 10.0, lambda: s - 10.0), (s > 0.0, lambda: s * 2.0)],
                    default=lambda: s * 0.0 - 1.0)
            st = p.jit.to_static(f, full_graph=True)
            out = [st(t(p, v)).numpy() for v in ([20.0], [3.0], [-5.0])]
            if p is tp:
                assert ops_of(st).count("conditional_block") == 1
            return out
        assert scalars(both(case)) == [10.0, 6.0, -1.0]

    def test_switch_eager_compiled_and_replay(self):
        def case(p):
            x = t(p, [1.0])

            def f(idx):
                return p.static.nn.switch_case(
                    idx, [lambda: x + 1.0, lambda: x + 10.0,
                          lambda: x + 100.0])
            st = p.jit.to_static(f, full_graph=True)
            out = []
            for i in (0, 1, 2, 9):
                out += [st(t(p, i, np.int32)).numpy(),
                        f(t(p, i, np.int32)).numpy()]
            if p is tp:
                assert ops_of(st) == ["switch_case"]
            return out
        got = both(case)
        assert scalars(got[::2]) == [2.0, 11.0, 101.0, 101.0]

    def test_switch_pairs_and_default(self):
        def case(p):
            x = t(p, [1.0])

            def f(idx):
                return p.static.nn.switch_case(
                    idx, [(3, lambda: x * 3.0), (7, lambda: x * 7.0)],
                    default=lambda: x * 0.0)
            st = p.jit.to_static(f, full_graph=True)
            return [st(t(p, i, np.int32)).numpy() for i in (3, 7, 5)]
        assert scalars(both(case)) == [3.0, 7.0, 0.0]

    @pytest.mark.parametrize("pkg", [jp, tp], ids=["jax", "port"])
    def test_switch_duplicate_keys_raise(self, pkg):
        with pytest.raises(ValueError, match="duplicate"):
            pkg.static.nn.switch_case(
                t(pkg, 0, np.int32),
                [(1, lambda: t(pkg, 1.0)), (1, lambda: t(pkg, 2.0))])

    def test_switch_grad_through_closed_over_param(self):
        def case(p):
            w = t(p, [2.0], grad=True)
            out = []
            if p is jp:
                @p.jit.to_static(full_graph=True)
                def f(idx):
                    o = p.static.nn.switch_case(
                        idx, [lambda: (w * 2.0).sum(), lambda: (w * w).sum()])
                    g, = p.autograd.grad([o], [w])
                    return o, g
                for i in (0, 1, 0):
                    out += [a.numpy() for a in f(t(p, i, np.int32))]
                return out
            st = p.jit.to_static(lambda idx: p.static.nn.switch_case(
                idx, [lambda: (w * 2.0).sum(), lambda: (w * w).sum()]),
                full_graph=True)
            for i in (0, 1, 0):
                o = st(t(p, i, np.int32))
                g, = p.autograd.grad([o], [w])
                out += [o.numpy(), g.numpy()]
            return out
        got = both(case)
        np.testing.assert_allclose(got[1], [2.0])
        np.testing.assert_allclose(got[3], [4.0])


class TestNesting:
    def test_cond_in_while_body(self):
        def case(p):
            i0, a0 = t(p, 0, np.int32), t(p, 1.0)

            def f(n):
                def body(i, a):
                    a2 = p.static.nn.cond(a > 10.0, lambda: a * 0.5,
                                          lambda: a * 2.0)
                    return [i + 1, a2]
                return p.static.nn.while_loop(lambda i, a: i < n, body,
                                              [i0, a0])[1]
            st = p.jit.to_static(f, full_graph=True)
            return [st(t(p, n, np.int32)).numpy() for n in (6, 3, 6)] + [
                f(t(p, 6, np.int32)).numpy()]
        assert scalars(both(case)) == [16.0, 8.0, 16.0, 16.0]

    def test_cond_in_cond(self):
        def case(p):
            def f(x):
                s = x.sum()
                return p.static.nn.cond(
                    s > 0.0,
                    lambda: p.static.nn.cond(s > 10.0, lambda: s * 100.0,
                                             lambda: s * 10.0),
                    lambda: s)
            st = p.jit.to_static(f, full_graph=True)
            return [st(t(p, v)).numpy() for v in ([20.0], [3.0], [-5.0])]
        assert scalars(both(case)) == [2000.0, 30.0, -5.0]


class TestGreedyDecode:
    """The worked example: a greedy decode as one while_loop over KV-cache
    state, one recording, the same ids on both packages."""

    V, D, T = 7, 5, 6

    def _build(self, p):
        V, D, T = self.V, self.D, self.T
        rng = np.random.RandomState(0)
        emb = t(p, rng.randn(V, D))
        wo = t(p, rng.randn(D, V))
        traces = []

        def decode(tok0):
            traces.append(1)
            state = {"step": t(p, 0, np.int32), "tok": tok0,
                     "kv": t(p, np.zeros((T, D))),
                     "out": t(p, np.zeros(T, np.int32), np.int32)}

            def body(st):
                h = p.ops.gather(emb, st["tok"].reshape([1]))
                kv = p.ops.scatter(st["kv"], st["step"].reshape([1]), h)
                ctx = kv.sum(axis=0) / (st["step"].astype("float32") + 1.0)
                logits = p.ops.matmul(ctx.reshape([1, D]), wo)
                nxt = p.ops.argmax(logits, axis=-1,
                                   dtype="int32").reshape([])
                out = p.ops.scatter(st["out"].reshape([T, 1]),
                                    st["step"].reshape([1]),
                                    nxt.reshape([1, 1])).reshape([T])
                return {"step": st["step"] + 1, "tok": nxt, "kv": kv,
                        "out": out}

            final = p.static.nn.while_loop(lambda st: st["step"] < T, body,
                                           [state])[0]
            return final["out"], final["kv"]
        return decode, traces

    def test_parity_and_single_program(self):
        def case(p):
            decode, traces = self._build(p)
            tok0 = t(p, 3, np.int32)
            out_e, kv_e = decode(tok0)
            st = p.jit.to_static(decode, full_graph=True)
            out_c, kv_c = st(tok0)
            out_c2, _ = st(tok0)
            np.testing.assert_array_equal(out_e.numpy(), out_c.numpy())
            np.testing.assert_array_equal(out_c.numpy(), out_c2.numpy())
            assert len(traces) == 2
            assert st.graph_break_reason is None
            if p is tp:
                assert ops_of(st).count("while_loop") == 1
            return [out_c.numpy(), kv_c.numpy(), kv_e.numpy()]
        both(case)

    def test_host_loop_matches(self):
        V, D, T = self.V, self.D, self.T
        rng = np.random.RandomState(0)
        emb, wo = rng.randn(V, D), rng.randn(D, V)
        kv, want, tok = np.zeros((T, D)), np.zeros(T, np.int32), 3
        for step in range(T):
            kv[step] = emb[tok]
            tok = int(np.argmax((kv.sum(0) / (step + 1.0)) @ wo))
            want[step] = tok
        decode, _ = self._build(tp)
        got, _ = decode(t(tp, 3, np.int32))
        np.testing.assert_array_equal(got.numpy(), want)


class TestAmp:
    def test_cond_under_auto_cast(self):
        def case(p):
            w, x = t(p, np.ones((4, 4))), t(p, np.ones((2, 4)))
            with p.amp.auto_cast(level="O1"):
                s = p.ops.matmul(x, w).sum()
                out = p.static.nn.cond(s > 0.0, lambda: s * 2.0,
                                       lambda: s * 0.5)
            return [out.astype("float32").numpy()]
        np.testing.assert_allclose(both(case)[0], 64.0, rtol=1e-2)
