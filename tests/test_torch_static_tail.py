"""The rest of the port's ``paddle.static`` against the JAX package's (the
cases of ``tests/test_static_dist_tail.py``'s ``TestStaticTail`` and the
rest of ``paddle_tpu/static/tail.py``): gradients, save/load and the
``.pdparams`` files across packages, the inference model through
``load_inference_model`` and the port's ``Predictor``, serialization,
scopes, the metrics and the places. fp32 within TOL (atol and rtol
1e-5).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from test_torch_static_program import build_both, rand, run_both

TOL = dict(rtol=1e-5, atol=1e-5)
W = rand(1, 4, 3)
C = rand(2, 2, 4)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _matmul_program(pkg, name):
    """x (fed) + a constant, times a named parameter holding W."""
    x = pkg.static.data("x", [2, 4], "float32")
    w = pkg.static.create_parameter([4, 3], "float32", name=name)
    w.set_value(pkg.to_tensor(W))
    y = pkg.matmul(x + pkg.to_tensor(C), w)
    return x, w, y


def test_static_all_is_the_jax_packages():
    want = [n for n in jp.static.__all__ if n != "verifier"]
    assert tp.static.__all__ == want
    assert all(hasattr(tp.static, n) for n in want)
    assert tp.static.tail.__all__ == jp.static.tail.__all__


def test_append_backward_and_gradients():
    got = {}
    for pkg in (jp, tp):
        with pkg.static.program_guard(pkg.static.Program()):
            x, w, y = _matmul_program(pkg, f"wab_{pkg.__name__}")
            loss = (y * y).mean()
            pairs = pkg.static.append_backward(loss)
            assert len(pairs) == 1 and pairs[0][0] is w
            (g,) = pkg.static.gradients([loss], [w])
            got[pkg] = (np.asarray(pairs[0][1].numpy()),
                        np.asarray(g.numpy()))
    for g, w in zip(got[tp], got[jp]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[tp][0], got[tp][1])


def test_save_load_roundtrip_and_pdparams_across_packages(tmp_path):
    progs = {}
    for pkg in (jp, tp):
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            progs[pkg] = (main,) + _matmul_program(pkg, "wsl")
    (jm, _, jw, _), (tm, _, tw, _) = progs[jp], progs[tp]
    # the port's round trip
    tp.static.save(tm, str(tmp_path / "t"))
    tw.set_value(tp.to_tensor(np.zeros((4, 3), np.float32)))
    tp.static.load(tm, str(tmp_path / "t"))
    np.testing.assert_allclose(tw.numpy(), W)
    st = tp.static.load_program_state(str(tmp_path / "t"))
    assert list(st) == ["wsl"]
    tp.static.set_program_state(tm, {"wsl": W * 2})
    np.testing.assert_allclose(tw.numpy(), W * 2)
    # the JAX package's file into the port, the port's into the JAX one
    jw.set_value(jp.to_tensor(W * 3))
    jp.static.save(jm, str(tmp_path / "j"))
    tp.static.load(tm, str(tmp_path / "j"))
    np.testing.assert_allclose(tw.numpy(), W * 3, **TOL)
    tw.set_value(tp.to_tensor(W * 5))
    tp.static.save(tm, str(tmp_path / "t"))
    jp.static.load(jm, str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(jw.numpy()), W * 5, **TOL)
    st = jp.static.load_program_state(str(tmp_path / "t"))
    np.testing.assert_allclose(st["wsl"], W * 5, **TOL)
    feed = {"x": rand(3, 2, 4)}
    run_both((jm, [progs[jp][3]]), (tm, [progs[tp][3]]), feed)


def test_inference_model_jax_loaded_layer_and_predictor(tmp_path):
    def build(pkg):
        x = pkg.static.data("x", [3, 6], "float32")
        h = pkg.static.nn.fc(x, 8, activation="relu")
        return [x, pkg.static.nn.fc(h, 2), h.sum()]
    (jm, (jx, jy, _)), (tm, (tx, ty, _)) = build_both(build, seed=2)
    jp.static.save_inference_model(str(tmp_path / "j"), [jx], [jy],
                                   program=jm)
    prefix = tp.static.save_inference_model(str(tmp_path / "t"), [tx],
                                            [ty], program=tm)
    xv = rand(4, 3, 6)
    j_layer, j_feeds, j_fetches = jp.static.load_inference_model(
        str(tmp_path / "j"))
    layer, feeds, fetches = tp.static.load_inference_model(prefix)
    assert (feeds, fetches) == (j_feeds, j_fetches) == (["x0"], ["out"])
    want = np.asarray(j_layer(jp.to_tensor(xv)).numpy())
    np.testing.assert_allclose(layer(tp.to_tensor(xv)).numpy(), want, **TOL)
    (ran,) = tp.static.Executor().run(tm, {"x": xv}, [ty])
    np.testing.assert_allclose(ran, want, **TOL)
    config = tp.inference.Config(prefix)
    config.disable_gpu()
    pred = tp.inference.create_predictor(config)
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(xv)
    pred.run()
    np.testing.assert_allclose(
        pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu(),
        want, **TOL)


def test_serialize_and_normalize(tmp_path):
    got = {}
    for pkg in (jp, tp):
        prog = pkg.static.Program()
        with pkg.static.program_guard(prog):
            x, w, y = _matmul_program(pkg, "wie")
        blob = pkg.static.serialize_program([x], [y], program=prog)
        pkg.static.save_to_file(str(tmp_path / pkg.__name__), blob)
        desc = pkg.static.deserialize_program(
            pkg.static.load_from_file(str(tmp_path / pkg.__name__)))
        state = pkg.static.serialize_persistables([x], [y], program=prog)
        w.set_value(pkg.to_tensor(np.zeros((4, 3), np.float32)))
        pkg.static.deserialize_persistables(prog, state)
        norm = pkg.static.normalize_program(prog, [x], [y])
        assert norm["program"] is prog and norm["fetches"] == [y]
        got[pkg] = (desc, np.asarray(w.numpy()))
    assert got[tp][0] == got[jp][0]
    assert got[tp][0]["ops"] == ["add", "matmul"]
    np.testing.assert_allclose(got[tp][1], W)


def test_scopes_ipu_misc(capsys):
    s = tp.static.Scope()
    with tp.static.scope_guard(s):
        assert tp.static.global_scope() is s
        s.var("a").set_tensor(42)
        assert s.find_var("a").get_tensor() == 42
    assert tp.static.global_scope() is not s
    for name in ("IpuStrategy", "IpuCompiledProgram"):
        with pytest.raises(RuntimeError, match="IPU"):
            getattr(tp.static, name)()
    with pytest.raises(RuntimeError, match="IPU"):
        tp.static.set_ipu_shard(None)
    with pytest.raises(RuntimeError, match="IPU"):
        with tp.static.ipu_shard_guard():
            pass
    with tp.static.name_scope("blk"), tp.static.device_guard("cpu"):
        pass
    t = tp.static.Print(tp.to_tensor(np.ones(3, np.float32)), message="dbg")
    assert list(t.shape) == [3] and "dbg" in capsys.readouterr().out
    assert tp.static.BuildStrategy().enable_inplace
    assert tp.static.WeightNormParamAttr(dim=0, name="wn").attr.name == "wn"
    assert tp.static.Variable is tp.Tensor
    g = tp.static.create_global_var([2, 3], 1.5, "float32", name="gv")
    j = jp.static.create_global_var([2, 3], 1.5, "float32", name="gv")
    np.testing.assert_allclose(g.numpy(), np.asarray(j.numpy()))
    assert g.name == "gv" and not g.persistable


def test_places():
    assert tp.static.cpu_places(2) == [tp.CPUPlace(0)] * 2
    assert len(tp.static.cpu_places()) == len(jp.static.cpu_places())
    # the CUDA devices here: none on a machine without a card
    import torch
    assert len(tp.static.cuda_places()) == torch.cuda.device_count()
    assert tp.static.cuda_places([0, 1]) == [tp.CUDAPlace(0),
                                             tp.CUDAPlace(1)]
    assert tp.static.xpu_places([1]) == [tp.CUDAPlace(1)]


def _metrics(pkg, pred, lab, bundle_pred, bundle_lab):
    acc = pkg.static.accuracy(pkg.to_tensor(pred[:2, :2]),
                              pkg.to_tensor(np.array([[1], [0]])))
    a, b, state = pkg.static.auc(pkg.to_tensor(pred[:, 1]),
                                 pkg.to_tensor(lab))
    bundle = pkg.static.ctr_metric_bundle(pkg.to_tensor(bundle_pred),
                                          pkg.to_tensor(bundle_lab))
    assert state == ()
    return [float(np.asarray(v.numpy())) for v in (acc, a, b) + bundle]


def test_static_metrics_match_jax():
    rng = np.random.RandomState(7)
    pred = rng.rand(300, 2).astype(np.float32)
    for lab in ((rng.rand(300) > 0.4).astype(np.float32),
                2.0 * (rng.rand(300) > 0.6).astype(np.float32),
                np.ones(300, np.float32)):
        bp = rng.rand(50).astype(np.float32)
        bl = (rng.rand(50) > 0.5).astype(np.float32)
        got = _metrics(tp, pred, lab, bp, bl)
        want = _metrics(jp, pred, lab, bp, bl)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[1] == 0.0          # a one-class batch scores 0.0


def test_auc_in_a_program_is_one_op():
    def build(pkg):
        p = pkg.static.data("p", [64], "float32")
        y = pkg.static.data("y", [64], "float32")
        return [pkg.static.auc(p, y)[0]]
    j, t = build_both(build)
    assert [op.name for op in t[0].global_block().ops] == ["auc"]
    rng = np.random.RandomState(3)
    # the JAX package computes its auc outside the dispatcher: its program
    # holds the build's value, the port's the run's
    p, y = rng.rand(64).astype(np.float32), (rng.rand(64) > 0.5).astype(
        np.float32)
    (got,) = tp.static.Executor().run(t[0], {"p": p, "y": y}, t[1])
    want = jp.static.auc(jp.to_tensor(p), jp.to_tensor(y))[0]
    np.testing.assert_allclose(got, np.asarray(want.numpy()), **TOL)
