"""paddle.geometric, the graph-learning ops (counterpart of
``paddle_tpu/geometric/__init__.py``): segment reductions, message
passing, neighbour sampling and reindexing.

The segment reductions and message passing are scatter-reduces on the
card (``index_add``, ``scatter_reduce``), differentiable through
``dispatch.call``. As in the JAX package, two things are read on the
host: a segment op's number of segments (the largest id + 1, the output
shape) and the whole of the samplers and the reindexing, whose outputs
are ragged and ordered by first occurrence; their results go back to
the input's device. The samplers seed their host draw from the device's
Paddle-API generator.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..core import dispatch
from ..core.generator import default_generator
from ..core.tensor import Tensor, as_tensor
from ..ops.registry import register_module

__all__ = [
    "send_u_recv", "send_ue_recv", "send_uv", "segment_sum", "segment_mean",
    "segment_min", "segment_max", "reindex_graph", "reindex_heter_graph",
    "sample_neighbors", "weighted_sample_neighbors",
]


def _t(x):
    return x if isinstance(x, Tensor) else as_tensor(x)


def _reduce(msgs: torch.Tensor, dst: torch.Tensor, n_out: int,
            how: str) -> torch.Tensor:
    """Rows of ``msgs`` reduced onto rows ``dst`` of an (n_out, ...)
    output; a row nothing reaches is 0."""
    dst = dst.long().reshape(-1)
    out = torch.zeros((n_out,) + tuple(msgs.shape[1:]), dtype=msgs.dtype,
                      device=msgs.device)
    if how == "sum":
        return out.index_add(0, dst, msgs)
    if how == "mean":
        tot = out.index_add(0, dst, msgs)
        cnt = torch.zeros(n_out, dtype=msgs.dtype, device=msgs.device
                          ).index_add(0, dst, torch.ones_like(dst,
                                                              dtype=msgs.dtype))
        return tot / cnt.clamp_min(1).reshape((-1,) + (1,) * (msgs.dim() - 1))
    if how not in ("min", "max"):
        raise ValueError(f"unknown reduce_op {how}")
    idx = dst.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    return out.scatter_reduce(0, idx, msgs, "amin" if how == "min"
                              else "amax", include_self=False)


def _segment(data, segment_ids, how, op_name):
    data, seg = _t(data), _t(segment_ids)
    # the number of segments is the output shape: read on the host
    n_seg = int(seg._data.max()) + 1 if seg.size else 0
    return dispatch.call(op_name, lambda d, s: _reduce(d, s, n_seg, how),
                         [data, seg], differentiable_mask=[True, False])


def segment_sum(data, segment_ids, name=None):
    """Sum of the rows of ``data`` of each segment id."""
    return _segment(data, segment_ids, "sum", "segment_sum")


def segment_mean(data, segment_ids, name=None):
    """Mean of the rows of ``data`` of each segment id."""
    return _segment(data, segment_ids, "mean", "segment_mean")


def segment_min(data, segment_ids, name=None):
    """Minimum of the rows of each segment id (0 for an empty one)."""
    return _segment(data, segment_ids, "min", "segment_min")


def segment_max(data, segment_ids, name=None):
    """Maximum of the rows of each segment id (0 for an empty one)."""
    return _segment(data, segment_ids, "max", "segment_max")


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """x[src] reduced onto the rows dst."""
    x, src, dst = _t(x), _t(src_index), _t(dst_index)
    n_out = int(out_size) if out_size is not None else x.shape[0]
    return dispatch.call("send_u_recv", lambda xa, s, d: _reduce(
        xa[s.long()], d, n_out, reduce_op), [x, src, dst],
        differentiable_mask=[True, False, False])


def _message(a, b, op):
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / b
    raise ValueError(f"unknown message_op {op}")


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """x[src] combined with the edge feature y (add, sub, mul, div), then
    reduced onto the rows dst."""
    x, y, src, dst = _t(x), _t(y), _t(src_index), _t(dst_index)
    n_out = int(out_size) if out_size is not None else x.shape[0]
    return dispatch.call("send_ue_recv", lambda xa, ya, s, d: _reduce(
        _message(xa[s.long()], ya, message_op), d, n_out, reduce_op),
        [x, y, src, dst], differentiable_mask=[True, True, False, False])


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """One message an edge: x[src] (op) y[dst]."""
    x, y, src, dst = _t(x), _t(y), _t(src_index), _t(dst_index)
    return dispatch.call("send_uv", lambda xa, ya, s, d: _message(
        xa[s.long()], ya[d.long()], message_op), [x, y, src, dst],
        differentiable_mask=[True, True, False, False])


# ------------------------------------------------------ host-side samplers
def _host(t) -> np.ndarray:
    return _t(t)._data.detach().cpu().numpy().ravel()


def _first_seen(values, mapping, order) -> None:
    for v in values.tolist():
        if v not in mapping:
            mapping[v] = len(order)
            order.append(v)


def _dev(t, device):
    return Tensor(torch.as_tensor(t, device=device))


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """(reindexed src, reindexed dst, out nodes): global ids compacted to
    local ones, x first, then new neighbours in order of first
    occurrence."""
    dev = _t(x)._data.device
    xs, nb, cnt = _host(x), _host(neighbors), _host(count)
    mapping, out_nodes = {}, []
    _first_seen(xs, mapping, out_nodes)
    _first_seen(nb, mapping, out_nodes)
    src = np.asarray([mapping[v] for v in nb.tolist()], np.int32)
    dst = np.repeat(np.arange(xs.shape[0]), cnt).astype(np.int32)
    return (_dev(src, dev), _dev(dst, dev),
            _dev(np.asarray(out_nodes, np.int32), dev))


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """``reindex_graph`` over one neighbour list and count per edge
    type."""
    dev = _t(x)._data.device
    xs = _host(x)
    mapping, out_nodes = {}, []
    _first_seen(xs, mapping, out_nodes)
    srcs, dsts = [], []
    for nb_t, cnt_t in zip(neighbors, count):
        nb, cnt = _host(nb_t), _host(cnt_t)
        _first_seen(nb, mapping, out_nodes)
        srcs.append(np.asarray([mapping[v] for v in nb.tolist()], np.int32))
        dsts.append(np.repeat(np.arange(xs.shape[0]), cnt).astype(np.int32))
    return (_dev(np.concatenate(srcs), dev), _dev(np.concatenate(dsts), dev),
            _dev(np.asarray(out_nodes, np.int32), dev))


def _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
            weights):
    dev = _t(input_nodes)._data.device
    nodes, rownp, ptr = _host(input_nodes), _host(row), _host(colptr)
    eid_np = _host(eids) if eids is not None else None
    if return_eids and eid_np is None:
        raise ValueError("return_eids=True requires eids")
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=default_generator(dev),
                             device=dev).item())
    rng = np.random.RandomState(seed)
    out, cnt, oeids = [], [], []
    for v in nodes.tolist():
        lo, hi = int(ptr[v]), int(ptr[v + 1])
        deg = hi - lo
        if sample_size < 0 or deg <= sample_size:
            pick = np.arange(lo, hi)
        else:
            p = None
            if weights is not None:
                w = weights[lo:hi]
                p = w / w.sum() if w.sum() > 0 else None
            pick = lo + rng.choice(deg, size=sample_size, replace=False, p=p)
        out.append(rownp[pick])
        cnt.append(pick.shape[0])
        if eid_np is not None:
            oeids.append(eid_np[pick])
    res = (_dev(np.concatenate(out) if out else np.zeros((0,), rownp.dtype),
                dev), _dev(np.asarray(cnt, np.int32), dev))
    if return_eids:
        return res + (_dev(np.concatenate(oeids), dev),)
    return res


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Up to ``sample_size`` in-neighbours of each input node, drawn
    uniformly without replacement from CSC storage: (neighbours, counts
    [, edge ids])."""
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
                   None)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    """``sample_neighbors`` with probabilities proportional to the edge
    weights."""
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
                   _host(edge_weight).astype(np.float64))


register_module(sys.modules[__name__], "geometric")
