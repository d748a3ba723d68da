"""Elastic re-sharding: move a checkpoint between mesh shapes (PyTorch port
of ``repro.checkpoint.elastic``).

Checkpoints store full (unsharded) arrays, so re-sharding is a pure
placement decision: each rank of the NEW mesh (``launch/mesh.Mesh``) takes
the slice of every leaf that its :class:`PartitionSpec` names and puts it on
``mesh.device``.  A spec names, per dimension, the mesh axis the dimension
is split over (``"model"`` or ``"data"``) or ``None`` (whole on every
rank); a split dimension gives rank ``i`` of an axis of ``n`` ranks its
contiguous ``[i·size/n, (i+1)·size/n)`` block — the lanes
``core.foem_sharded.shard_stats`` gives, and ``NamedSharding``'s block
layout in the JAX package.  This supports shrink (node loss), grow and axis
reshape: a run killed on a (2, 2) mesh resumes on (1, 2) from the same
checkpoint.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import restore_checkpoint, tree_map


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (or ``None``) of one leaf — the
    counterpart of ``jax.sharding.PartitionSpec``; a leaf of a spec tree.
    Dimensions past the spec's length are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _place(leaf, spec: PartitionSpec, mesh) -> torch.Tensor:
    t = (leaf if isinstance(leaf, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(leaf)))
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec!r} has more axes than the leaf's "
                         f"{t.dim()} dimensions")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        ax = getattr(mesh, axis)
        size = t.shape[dim]
        if size % ax.size:
            raise ValueError(f"dimension {dim} of size {size} does not "
                             f"split over the {ax.size} {axis} ranks")
        lo = ax.index * size // ax.size
        t = t.narrow(dim, lo, size // ax.size)
    return t.contiguous().to(mesh.device)


def reshard(tree: Any, spec_tree: Any, mesh) -> Any:
    """This rank's slices of a host pytree, placed on ``mesh.device``
    according to ``spec_tree`` (the tree's structure with a
    :class:`PartitionSpec` at every leaf)."""
    return tree_map(lambda leaf, spec: _place(leaf, spec, mesh),
                    tree, spec_tree)


def restore_resharded(path: str, like: Any, spec_tree: Any, mesh,
                      step=None):
    """``restore_checkpoint`` then :func:`reshard` onto ``mesh``."""
    step, host_tree = restore_checkpoint(path, like, step=step)
    return step, reshard(host_tree, spec_tree, mesh)
