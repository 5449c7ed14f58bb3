"""``geometric`` of the port against the JAX package: the segment
reductions (empty segments too), the three message-passing ops with
every reduce and message op, their gradients, reindexing (homogeneous
and heterogeneous), and the neighbour samplers (the full neighbourhoods
exactly; sampled ones by their counts, membership and a repeat under one
port seed). Values to 1e-5."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.RandomState(0)
X = RNG.randn(6, 3).astype(np.float32)
E = RNG.randn(9, 3).astype(np.float32)
SRC = np.array([0, 1, 2, 3, 4, 5, 0, 2, 4], np.int64)
DST = np.array([1, 2, 3, 3, 0, 0, 5, 1, 1], np.int64)
SEG = np.array([0, 0, 1, 3, 3, 3, 4, 4, 4], np.int64)   # segment 2 empty


@pytest.fixture(autouse=True)
def _cpu():
    state = jp.get_rng_state()
    with tp.device_guard("cpu"):
        yield
    jp.set_rng_state(state)


def both(fn, grad_of=None):
    outs = []
    for p in (jp, tp):
        ts = {k: p.to_tensor(v, stop_gradient=(k not in (grad_of or ())))
              for k, v in dict(x=X, e=E, src=SRC, dst=DST, seg=SEG).items()}
        out = fn(p, ts)
        res = [out.numpy()]
        if grad_of:
            (out * out).sum().backward()
            res += [ts[k].grad.numpy() for k in grad_of]
        outs.append(res)
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, np.asarray(j), **TOL)
    return outs[1]


@pytest.mark.parametrize("how", ["sum", "mean", "min", "max"])
def test_segments(how):
    both(lambda p, t: getattr(p.geometric, f"segment_{how}")(t["e"],
                                                               t["seg"]),
         grad_of=("e",))


@pytest.mark.parametrize("red", ["sum", "mean", "min", "max"])
def test_send_u_recv(red):
    both(lambda p, t: p.geometric.send_u_recv(t["x"], t["src"], t["dst"],
                                              reduce_op=red), grad_of=("x",))
    both(lambda p, t: p.geometric.send_u_recv(t["x"], t["src"], t["dst"],
                                              reduce_op=red, out_size=8))


@pytest.mark.parametrize("msg", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("red", ["sum", "max"])
def test_send_ue_recv(msg, red):
    both(lambda p, t: p.geometric.send_ue_recv(
        t["x"], t["e"] if msg != "div" else t["e"] * t["e"] + 1.0, t["src"],
        t["dst"], message_op=msg, reduce_op=red), grad_of=("x", "e"))


@pytest.mark.parametrize("msg", ["add", "sub", "mul", "div"])
def test_send_uv(msg):
    both(lambda p, t: p.geometric.send_uv(
        t["x"], t["x"] * t["x"] + 1.0, t["src"], t["dst"], message_op=msg),
        grad_of=("x",))


def test_reindex_graph():
    x = np.array([5, 9, 2], np.int64)
    nb = np.array([9, 7, 2, 7, 11, 5, 3], np.int64)
    cnt = np.array([2, 3, 2], np.int64)
    outs = [[o.numpy() for o in p.geometric.reindex_graph(
        p.to_tensor(x), p.to_tensor(nb), p.to_tensor(cnt))]
        for p in (jp, tp)]
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, np.asarray(j))
    nbs = [np.array([9, 7], np.int64), np.array([7, 13, 5], np.int64)]
    cnts = [np.array([1, 1, 0], np.int64), np.array([1, 1, 1], np.int64)]
    outs = [[o.numpy() for o in p.geometric.reindex_heter_graph(
        p.to_tensor(x), [p.to_tensor(a) for a in nbs],
        [p.to_tensor(c) for c in cnts])] for p in (jp, tp)]
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, np.asarray(j))


def _csc():
    order = np.argsort(DST, kind="stable")
    colptr = np.searchsorted(DST[order], np.arange(7)).astype(np.int64)
    return SRC[order], colptr, np.arange(9, dtype=np.int64)[order]


def test_sample_neighbors_full_and_sampled():
    row, colptr, eids = _csc()
    nodes = np.array([1, 3, 0, 2], np.int64)
    full = [[o.numpy() for o in p.geometric.sample_neighbors(
        p.to_tensor(row), p.to_tensor(colptr), p.to_tensor(nodes),
        eids=p.to_tensor(eids), return_eids=True)] for p in (jp, tp)]
    for j, t in zip(*full):
        np.testing.assert_array_equal(t, np.asarray(j))
    tp.seed(3)
    nb, cnt = tp.geometric.sample_neighbors(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(nodes),
        sample_size=1)
    np.testing.assert_array_equal(cnt.numpy(), [1, 1, 1, 1])
    starts = np.concatenate([[0], np.cumsum(cnt.numpy())[:-1]])
    for k, v in enumerate(nodes):
        assert nb.numpy()[starts[k]] in row[colptr[v]:colptr[v + 1]]
    tp.seed(3)
    again, _ = tp.geometric.sample_neighbors(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(nodes),
        sample_size=1)
    np.testing.assert_array_equal(again.numpy(), nb.numpy())


def test_weighted_sample_neighbors():
    row, colptr, _ = _csc()
    w = np.ones(9, np.float32)
    w[row == 4] = 1e6              # node 1's neighbour 4 all but always
    nb, cnt = tp.geometric.weighted_sample_neighbors(
        tp.to_tensor(row), tp.to_tensor(colptr), tp.to_tensor(w),
        tp.to_tensor(np.array([1], np.int64)), sample_size=1)
    assert cnt.numpy().tolist() == [1] and nb.numpy().tolist() == [4]
    full = [[o.numpy() for o in p.geometric.weighted_sample_neighbors(
        p.to_tensor(row), p.to_tensor(colptr), p.to_tensor(w),
        p.to_tensor(np.array([0, 1], np.int64)))] for p in (jp, tp)]
    for j, t in zip(*full):
        np.testing.assert_array_equal(t, np.asarray(j))
