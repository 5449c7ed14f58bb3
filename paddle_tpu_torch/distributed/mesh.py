"""The process mesh (counterpart of ``paddle_tpu/distributed/mesh.py``).

The JAX package's topology is a ``jax.sharding.Mesh`` of devices. The
port's is a named grid of ranks, one process a card: rank r sits at the
row-major coordinate of r in the grid (the JAX mesh's device order, so
that rank r's tensor is shard r of the JAX global array), and each axis
has one group a line of the grid. ``build_mesh`` makes every axis group
(collective: every rank builds the same mesh, in the same order);
``Mesh.group(axes)`` makes the groups over several axes together.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

# Canonical hybrid axis order (reference topology.py hybrid_group_names
# order: data, pipe, sharding, sep, model).
HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")


class Mesh:
    """``shape``: axis name -> size, in order; ranks fill the grid row
    major. ``devices`` is the grid of ranks (the JAX mesh's name for it)."""

    def __init__(self, shape: Dict[str, int]):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape: Dict[str, int] = {a: int(n) for a, n in shape.items()}
        self.size = int(np.prod(list(self.shape.values()) or [1]))
        self.devices = np.arange(self.size).reshape(
            [self.shape[a] for a in self.axis_names])
        self._groups = {}

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def comm_lists(self, axes: Sequence[str]):
        """The rank lists of the groups over ``axes``: one a coordinate of
        the other axes, ranks ordered by their coordinates on ``axes``."""
        axes = [a for a in axes if a in self.shape]
        rest = [a for a in self.axis_names if a not in axes]
        perm = [self.axis_names.index(a) for a in rest + axes]
        n = int(np.prod([self.shape[a] for a in axes] or [1]))
        grid = np.transpose(self.devices, perm).reshape(-1, n)
        return [row.tolist() for row in grid]

    def group(self, axes: Sequence[str]):
        """This rank's group over ``axes`` (made on first use, every line
        of them, collectively)."""
        from .communication.group import _make
        key = tuple(a for a in axes if a in self.shape)
        if key not in self._groups:
            me = dist.get_rank()
            mine = None
            for ranks in self.comm_lists(key):
                g = _make(ranks, axes=key)
                if me in ranks:
                    mine = g
            self._groups[key] = mine
        return self._groups[key]

    def __repr__(self):
        return f"Mesh({self.shape})"


_global_mesh: Optional[Mesh] = None
_lock = threading.Lock()


def build_mesh(shape=None, axis_names: Sequence[str] = None) -> Mesh:
    """A mesh over every rank of the world: ``shape`` maps axis name ->
    size (a dict), or is a list of sizes with ``axis_names``; the default
    is one ``dp`` axis over the world. Makes each axis's groups."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh: the parallel environment is not "
                           "initialized; call init_parallel_env() first")
    world = dist.get_world_size()
    if shape is None:
        shape = {"dp": world}
    elif not isinstance(shape, dict):
        shape = dict(zip(axis_names, shape))
    mesh = Mesh(shape)
    if mesh.size != world:
        raise ValueError(f"mesh shape {mesh.shape} needs {mesh.size} ranks, "
                         f"the world has {world}")
    for axis in mesh.axis_names:
        mesh.group((axis,))
    return mesh


def set_mesh(mesh: Mesh) -> Mesh:
    global _global_mesh
    with _lock:
        _global_mesh = mesh
    return mesh


def get_mesh() -> Mesh:
    """The current mesh; a ``dp`` mesh over the world when none was set."""
    global _global_mesh
    if _global_mesh is None:
        mesh = build_mesh()
        with _lock:
            if _global_mesh is None:
                _global_mesh = mesh
    return _global_mesh


def has_mesh() -> bool:
    return _global_mesh is not None


def axis_size(axis: str) -> int:
    return get_mesh().axis_size(axis)


def _reset():
    global _global_mesh
    with _lock:
        _global_mesh = None
