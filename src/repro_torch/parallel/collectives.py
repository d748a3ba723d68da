"""Collectives over one axis of a mesh of ranks (PyTorch port of
``repro.parallel.collectives``): an all-reduce as reduce-scatter plus
all-gather, an all-reduce in chunks with work between them, a ring
all-gather built of permutes, and the tiled all-to-all of the EP router.

Each takes a ``launch.mesh.MeshAxis`` — the ranks along the axis and their
process group — where the JAX functions take an axis name inside
``shard_map``, and every rank of the axis calls it with a tensor of one
shape.  On an axis of size 1 each returns its input's values.

Transport, as in ``MeshAxis.all_reduce``: gloo takes CPU tensors, so on a
gloo group a CUDA buffer goes through the host and comes back; NCCL takes
CUDA buffers where they lie.  gloo has no reduce-scatter: there it is an
``all_to_all_single`` of the blocks and a local sum, in the senders' order;
NCCL has ``reduce_scatter_tensor`` and ``all_gather_into_tensor``.  The
NCCL branches have not run: they need a card per rank, and this repo's
card runs hold one (ranks that share a card meet over gloo).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _gloo_host(x: torch.Tensor, axis) -> bool:
    """Whether ``x`` must go through the host on ``axis``'s group."""
    return (x.device.type != "cpu"
            and dist.get_backend(axis.group) == "gloo")


def _split_rows(x: torch.Tensor, n: int) -> None:
    if x.shape[0] % n:
        raise ValueError(f"a tiled collective over {n} ranks needs a leading "
                         f"axis that they divide, got {tuple(x.shape)}")


def reduce_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``: x's
    leading axis in ``axis.size`` blocks, and this rank gets the sum over
    the ranks of its block (at its coordinate)."""
    if axis.size == 1:
        return x
    _split_rows(x, axis.size)
    x = x.contiguous()
    rows = x.shape[0] // axis.size
    if dist.get_backend(axis.group) != "gloo":
        out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, group=axis.group)
        return out
    host = _gloo_host(x, axis)
    send = x.cpu() if host else x
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    out = recv.reshape((axis.size, rows) + tuple(x.shape[1:])).sum(0)
    return out.to(x.device) if host else out


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=0, tiled=True)``: the ranks' tensors
    concatenated on the leading axis, in the ranks' order."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    if dist.get_backend(axis.group) != "gloo":
        out = torch.empty((axis.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=axis.group)
        return out
    host = _gloo_host(x, axis)
    send = x.cpu() if host else x
    parts = [torch.empty_like(send) for _ in range(axis.size)]
    dist.all_gather(parts, send, group=axis.group)
    out = torch.cat(parts, 0)
    return out.to(x.device) if host else out


def psum_scatter_then_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """The all-reduce of x as a reduce-scatter and an all-gather: the same
    sums as ``axis.all_reduce``, in two phases a caller may put work
    between (:func:`reduce_scatter`, :func:`all_gather`)."""
    return all_gather(reduce_scatter(x, axis), axis)


def chunked_psum(x: torch.Tensor, axis, num_chunks: int,
                 between: Optional[Callable[[int], None]] = None
                 ) -> torch.Tensor:
    """The all-reduce of x in ``num_chunks`` slices of its leading axis,
    ``between(i)`` called after slice i's; one all-reduce when
    ``num_chunks`` is 1 or does not divide the axis (``between`` is then
    not called), as in the JAX package."""
    n = x.shape[0]
    if num_chunks <= 1 or n % num_chunks:
        return axis.all_reduce(x)[0]
    out = []
    for i, part in enumerate(torch.chunk(x, num_chunks, 0)):
        out.append(axis.all_reduce(part.contiguous())[0])
        if between is not None:
            between(i)
    return torch.cat(out, 0)


def ppermute(x: torch.Tensor, axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each (source, destination) pair of axis
    coordinates in ``perm``, the source's x goes to the destination; a rank
    that no pair sends to gets zeros.  One ``batch_isend_irecv`` over the
    axis's group, its peers as global ranks."""
    dst = [d for s, d in perm if s == axis.index]
    src = [s for s, d in perm if d == axis.index]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at "
                         f"{axis.index}")
    x = x.contiguous()
    if axis.size == 1:
        return x.clone() if src else torch.zeros_like(x)
    host = _gloo_host(x, axis)
    send = x.cpu() if host else x
    recv = torch.zeros_like(send)
    ops = []
    if dst:
        if dst[0] == axis.index:
            recv.copy_(send)
        else:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(axis.group, dst[0]),
                                  group=axis.group))
    if src and src[0] != axis.index:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(axis.group, src[0]),
                              group=axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if host else recv


def ring_all_gather(x: torch.Tensor, axis, axis_size: int) -> torch.Tensor:
    """The all-gather as ``axis_size − 1`` hops of a ring permute (each rank
    sends to the next): the ranks' tensors stacked on a new leading axis in
    the ranks' order (hop j brings rank (i − j)'s tensor to rank i)."""
    if axis_size != axis.size:
        raise ValueError(f"axis_size {axis_size} is not the axis's "
                         f"{axis.size}")
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    chunks: List[torch.Tensor] = [x]
    cur = x
    for _ in range(axis_size - 1):
        cur = ppermute(cur, axis, perm)
        chunks.append(cur)
    # chunk j came from rank (index − j) mod N: rank i's is chunk
    # (index − i) mod N
    return torch.stack([chunks[(axis.index - i) % axis_size]
                        for i in range(axis_size)], 0)


def all_to_all_tokens(x: torch.Tensor, axis, axis_size: int, *,
                      split_axis: int = 0, concat_axis: int = 0
                      ) -> torch.Tensor:
    """The tiled ``lax.all_to_all``: x's ``split_axis`` in ``axis_size``
    blocks, block j to the rank at coordinate j, and the blocks received
    concatenated on ``concat_axis`` in the senders' order."""
    if axis_size != axis.size:
        raise ValueError(f"axis_size {axis_size} is not the axis's "
                         f"{axis.size}")
    if x.shape[split_axis] % axis_size:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not split over {axis_size} ranks")
    blocks = torch.stack(torch.chunk(x, axis_size, split_axis), 0)
    recv = axis.all_to_all(blocks)
    return torch.cat(recv.unbind(0), concat_axis)
