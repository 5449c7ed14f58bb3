"""Communication groups (counterpart of
``paddle_tpu/distributed/communication/group.py``).

The JAX package is single-controller: a ``Group`` names mesh axes and
its ranks are coordinates along them. The port is multi-controller, one
process a card, as the reference framework is: a ``Group`` is a list of
global ranks bound to a ``torch.distributed`` process group (NCCL on the
cards, gloo when the caller asked for the CPU). ``ranks`` are global
ranks in group order (ascending, as torch orders a group); ``rank`` is
this process's index in the group, -1 when it is not a member.

Creating a group is collective: ``new_group`` must be entered by every
process of the world, in the same order, members or not (torch's
contract). A group of one rank needs no communicator, and gets none: its
collectives are local.
"""
from __future__ import annotations

import itertools
import weakref
from typing import List, Optional, Sequence

import torch.distributed as dist


class Group:
    def __init__(self, ranks: Sequence[int], pg=None, axes=(), gid: int = 0,
                 name: Optional[str] = None):
        self.ranks: List[int] = list(ranks)
        self.pg = pg
        self.axes = tuple(axes)
        self.id = gid
        self.name = name or f"group_{gid}"
        me = dist.get_rank() if dist.is_initialized() else 0
        self.rank = self.ranks.index(me) if me in self.ranks else -1
        _live.add(self)

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def process_group(self):
        return self.pg

    @property
    def process_ids(self):
        return self.ranks

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, rank: int) -> int:
        """Index of global ``rank`` in the group, -1 if it is not in it."""
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, axes={self.axes}, "
                f"rank={self.rank})")


_group_counter = itertools.count(1)
_groups: dict = {}
#: every Group alive, members or not: destroying the world unbinds each
#: from its process group, so that no Group a caller still holds keeps a
#: communicator (and its threads) alive past the teardown
_live: "weakref.WeakSet[Group]" = weakref.WeakSet()


def _require_init(what: str):
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: the parallel environment is not "
                           f"initialized; call init_parallel_env() first")


def get_default_group() -> Group:
    """The world: every rank, over the default process group."""
    _require_init("get_default_group")
    if 0 not in _groups:
        _groups[0] = Group(range(dist.get_world_size()),
                           pg=dist.group.WORLD, gid=0, name="world")
    return _groups[0]


def get_group(id: int = 0) -> Group:
    """Group by id (reference communication/group.py:199)."""
    if id == 0:
        return get_default_group()
    try:
        return _groups[id]
    except KeyError:
        raise ValueError(f"no group with id {id}; create it with new_group")


def _make(ranks: Sequence[int], axes=(), timeout=None) -> Group:
    """A group over ``ranks`` (collective: every rank of the world calls
    it with the same ranks). One rank: no communicator."""
    ranks = sorted(int(r) for r in ranks)
    world = dist.get_world_size()
    if len(set(ranks)) != len(ranks) or any(not 0 <= r < world
                                            for r in ranks):
        raise ValueError(f"new_group: ranks {ranks} must be distinct ranks "
                         f"of a world of {world}")
    if ranks == list(range(world)) and not axes:
        pg = dist.group.WORLD
    elif len(ranks) == 1:
        pg = None
    else:
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, **kw)
    g = Group(ranks, pg=pg, axes=axes, gid=next(_group_counter))
    if g.is_member():
        _groups[g.id] = g
    return g


def new_group(ranks=None, backend=None, timeout=None, axes=None) -> Group:
    """A group over ``ranks`` (default: every rank), or with ``axes``
    the group of this rank over those axes of the current mesh (which
    makes every group of those axes, one per coordinate of the others).
    Collective: every rank calls it, in the same order. ``backend`` is
    the world's (NCCL on the cards, gloo on the CPU) and may not differ."""
    _require_init("new_group")
    if backend is not None and backend != dist.get_backend():
        raise ValueError(f"new_group: backend {backend!r} differs from the "
                         f"world's {dist.get_backend()!r}")
    if axes is not None:
        from .. import mesh as mesh_mod
        return mesh_mod.get_mesh().group(
            (axes,) if isinstance(axes, str) else tuple(axes))
    if ranks is None:
        ranks = range(dist.get_world_size())
    return _make(ranks, timeout=timeout)


def is_initialized() -> bool:
    return dist.is_initialized()


def destroy_process_group(group: Optional[Group] = None):
    """Destroy ``group``'s communicator, or with no group every group,
    the world, the mesh and the hybrid topology; every ``Group`` is
    unbound from its process group, so that the communicators' threads
    end when the process groups are collected. A no-op once the world is
    gone."""
    if group is not None:
        if group.pg not in (None, dist.group.WORLD):
            dist.destroy_process_group(group.pg)
            group.pg = None
        _groups.pop(group.id, None)
        return
    for g in list(_live):
        g.pg = None
    _groups.clear()
    from .. import mesh as mesh_mod
    from ..fleet.base import topology
    mesh_mod._reset()
    topology.set_hybrid_communicate_group(None)
    if dist.is_initialized():
        dist.destroy_process_group()
