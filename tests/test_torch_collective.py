"""The port's collectives against the JAX package's.

One 4-process gloo cluster through the port's launcher
(``tests/torch_dist_worker.py collectives``) runs every collective on the
world and on each axis group of a dp2 x mp2 mesh. The JAX package runs
the same collective on a 4-device virtual mesh of the same axes, on the
global array whose shard r is rank r's tensor, and the port's rank r
must hold that array's shard r (fp32 to 1e-6; the data are small
integers, so sums, products and averages are exact up to rounding). The
JAX package is single-controller, so what it has no per-rank form of —
distinct objects on each rank (``all_gather_object``), an unpaired
``send``/``recv`` — is held against the rank semantics directly. The
worker itself asserts what must raise (a src outside the group, a rank
outside the group, an unknown op, an uneven scatter).
"""
import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu.distributed.communication.collective as JC
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.communication.group import Group as JGroup
from torch_dist_harness import launch, logs, outputs

N = 4
AXES = {"world": ("dp", "mp"), "dp": ("dp",), "mp": ("mp",)}
TOL = dict(rtol=1e-6, atol=1e-6)


def _coord(rank):
    return {"dp": rank // 2, "mp": rank % 2}


def _members(gname, rank):
    """The port's group of ``rank``: global ranks in group order."""
    if gname == "world":
        return list(range(N))
    c = _coord(rank)
    return [r for r in range(N) if all(_coord(r)[a] == c[a]
                                       for a in ("dp", "mp") if a != gname)]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = rng.randint(-3, 4, (N, 4, 3)).astype(np.float32)
    out = tmp_path_factory.mktemp("collectives")
    proc = launch("collectives", N, {"x": x}, str(out))
    assert proc.returncode == 0, proc.stderr + logs(str(out))
    return x, outputs(str(out), "collectives", N)


@pytest.fixture(scope="module")
def jax_mesh():
    old = jmesh._global_mesh
    mesh = jmesh.build_mesh({"dp": 2, "mp": 2}, devices=jax.devices()[:N])
    jmesh.set_mesh(mesh)
    yield mesh
    jmesh._global_mesh = old


def _global(mesh, per_rank):
    """The JAX array whose shard r (of 4, over dp then mp) is per_rank[r]."""
    return JTensor(jax.device_put(np.concatenate(per_rank),
                                  NamedSharding(mesh, P(("dp", "mp")))))


def _local(mesh, t, rank):
    """Rank ``rank``'s shard of the JAX result ``t``."""
    arr = t._data if isinstance(t, JTensor) else t
    dev = mesh.devices.flatten()[rank]
    for s in arr.addressable_shards:
        if s.device == dev:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {dev}")


def _group(mesh, gname):
    return JGroup(AXES[gname], mesh=mesh)


@pytest.mark.parametrize("gname", list(AXES))
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_all_reduce(cluster, jax_mesh, gname, op):
    x, got = cluster
    t = JC.all_reduce(_global(jax_mesh, x), op=op,
                      group=_group(jax_mesh, gname))
    for r in range(N):
        np.testing.assert_allclose(got[r][f"{gname}.all_reduce.{op}"],
                                   _local(jax_mesh, t, r), **TOL)


@pytest.mark.parametrize("gname", list(AXES))
def test_all_gather(cluster, jax_mesh, gname):
    x, got = cluster
    parts = JC.all_gather([], _global(jax_mesh, x),
                          group=_group(jax_mesh, gname))
    for r in range(N):
        want = np.stack([_local(jax_mesh, p, r) for p in parts])
        np.testing.assert_allclose(got[r][f"{gname}.all_gather"], want, **TOL)


@pytest.mark.parametrize("gname", list(AXES))
@pytest.mark.parametrize("op", ["sum", "max", "avg"])
def test_reduce_scatter(cluster, jax_mesh, gname, op):
    x, got = cluster
    t = JC.reduce_scatter(None, _global(jax_mesh, x), op=op,
                          group=_group(jax_mesh, gname))
    for r in range(N):
        np.testing.assert_allclose(got[r][f"{gname}.reduce_scatter.{op}"],
                                   _local(jax_mesh, t, r), **TOL)
        if op == "sum":     # the list form: one chunk a rank, concatenated
            np.testing.assert_allclose(got[r][f"{gname}.reduce_scatter.list"],
                                       _local(jax_mesh, t, r), **TOL)


@pytest.mark.parametrize("gname", list(AXES))
def test_broadcast_reduce_scatter_from_a_root(cluster, jax_mesh, gname):
    """broadcast from the group's last member, reduce to and scatter from
    its first (the port names them by global rank, the JAX package by
    index in the group)."""
    x, got = cluster
    g = _group(jax_mesh, gname)
    n = len(_members(gname, 0))
    b = JC.broadcast(_global(jax_mesh, x), src=n - 1, group=g)
    red = JC.reduce(_global(jax_mesh, x), dst=0, group=g)
    sc = JC.scatter(_global(jax_mesh, [np.zeros((4 // n, 3), np.float32)] * N),
                    _global(jax_mesh, x), src=0, group=g)
    for r in range(N):
        np.testing.assert_allclose(got[r][f"{gname}.broadcast"],
                                   _local(jax_mesh, b, r), **TOL)
        np.testing.assert_allclose(got[r][f"{gname}.scatter"],
                                   _local(jax_mesh, sc, r), **TOL)
        if _members(gname, r)[0] == r:      # only dst holds the reduction
            np.testing.assert_allclose(got[r][f"{gname}.reduce"],
                                       _local(jax_mesh, red, r), **TOL)
        else:
            assert f"{gname}.reduce" not in got[r]


@pytest.mark.parametrize("gname", list(AXES))
def test_alltoall(cluster, jax_mesh, gname):
    """Rank i's j-th chunk lands as rank j's i-th: the JAX list form on
    the global arrays whose shard r is chunk j of rank r's tensor; the
    port's alltoall_single (equal chunks of one tensor) gives the same."""
    x, got = cluster
    n = len(_members(gname, 0))
    ins = [_global(jax_mesh, [np.split(x[r], n)[j] for r in range(N)])
           for j in range(n)]
    outs = JC.alltoall([], ins, group=_group(jax_mesh, gname))
    for r in range(N):
        want = np.concatenate([_local(jax_mesh, o, r) for o in outs])
        np.testing.assert_allclose(got[r][f"{gname}.alltoall"], want, **TOL)
        # the JAX alltoall_single reshapes the global array (ROADMAP
        # Queue 3): the port's is the list form's rank semantics
        np.testing.assert_allclose(got[r][f"{gname}.alltoall_single"],
                                   want, **TOL)


@pytest.mark.parametrize("gname", list(AXES))
def test_ring_exchange_and_shift(cluster, jax_mesh, gname):
    """batch_isend_irecv of a ring (group rank i to i + 1), and
    shift_along_axis by 1, against the JAX ppermute of that ring."""
    x, got = cluster
    n = len(_members(gname, 0))
    g = _group(jax_mesh, gname)
    src = _global(jax_mesh, x)
    sends = []
    for i in range(n):
        op = JC.P2POp(JC.isend, src, (i + 1) % n, group=g)
        op.src_rank = i
        sends.append(op)
    recv = _global(jax_mesh, np.zeros_like(x))
    JC.batch_isend_irecv(sends + [JC.P2POp(JC.irecv, recv, 0, group=g)])
    for r in range(N):
        want = _local(jax_mesh, recv, r)
        np.testing.assert_allclose(got[r][f"{gname}.ring"], want, **TOL)
        if gname != "world":
            np.testing.assert_allclose(got[r][f"{gname}.shift"], want, **TOL)


@pytest.mark.parametrize("gname", list(AXES))
def test_object_collectives(cluster, gname):
    _, got = cluster
    for r in range(N):
        members = _members(gname, r)
        np.testing.assert_array_equal(
            got[r][f"{gname}.all_gather_object"],
            [[m, i] for i, m in enumerate(members)])
        np.testing.assert_array_equal(
            got[r][f"{gname}.broadcast_object_list"],
            [-1, members[0]])


def test_send_recv_and_async_paddle_tensor(cluster, jax_mesh):
    x, got = cluster
    t = JC.all_reduce(_global(jax_mesh, x), group=_group(jax_mesh, "dp"))
    for r in range(N):
        if _coord(r)["mp"] == 1:
            np.testing.assert_array_equal(got[r]["mp.send_recv"], x[r - 1])
        np.testing.assert_allclose(got[r]["dp.all_reduce.task_paddle"],
                                   _local(jax_mesh, t, r), **TOL)
        np.testing.assert_array_equal(got[r]["perf.sizes"], [4096, 65536])
