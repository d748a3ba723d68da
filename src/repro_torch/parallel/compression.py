"""Gradient compression for the data-parallel all-reduce: int8 with one
scale a tile of 256, and error feedback (PyTorch port of
``repro.parallel.compression``).

``compress`` adds the residual carried from the last step to the gradient,
quantises each tile of ``TILE`` elements symmetrically to int8 at
``max|·| / 127`` (at least 1e-12) and keeps the new residual (Seide et
al.; Karimireddy et al.): the quantisation error is folded into the next
step instead of lost.  The float32 arithmetic is the JAX package's, in its
order, and both round half to even, so ``compress`` matches it bit for bit.

``compressed_psum`` sums the dequantised payloads over an axis of ranks
(``launch.mesh.MeshAxis``): each rank's tiles carry their own scales, so the
sum is of ``q · scale`` in float32.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

TILE = 256


class EFState(NamedTuple):
    error: torch.Tensor     # the residual carried to the next step (float32)


class Carrier(NamedTuple):
    q: torch.Tensor         # (tiles, TILE) int8 payload
    scale: torch.Tensor     # (tiles,) float32 scales


def ef_init(x: torch.Tensor) -> EFState:
    return EFState(error=torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device))


def compress(x: torch.Tensor, state: EFState) -> Tuple[Carrier, EFState]:
    """int8 symmetric quantisation with a scale a 256-element tile, and the
    residual for the next step.  The last tile is padded with zeros."""
    flat = (x.float() + state.error).reshape(-1)
    n = flat.shape[0]
    tiles = F.pad(flat, (0, (-n) % TILE)).reshape(-1, TILE)
    scale = (tiles.abs().amax(1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(tiles / scale).clamp(-127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[:n]
    err = (flat - deq).reshape(x.shape)
    return Carrier(q=q, scale=scale[:, 0]), EFState(error=err)


def decompress(c: Carrier, shape, dtype=torch.float32) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    deq = c.q.float() * c.scale[:, None]
    return deq.reshape(-1)[:n].reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, axis, state: EFState
                    ) -> Tuple[torch.Tensor, EFState]:
    """The error-feedback int8 all-reduce over ``axis``: this rank's
    payload, dequantised with its own scales, summed in float32 over the
    ranks; returns the sum in x's shape and the new state."""
    c, state = compress(x, state)
    # The JAX function also sums q as int32 over the axis and then discards
    # it (the scales differ between ranks, so the integer sum means
    # nothing); the port makes no such collective.
    (tot,) = axis.all_reduce(c.q.float() * c.scale[:, None])
    return tot.reshape(-1)[:x.numel()].reshape(x.shape), state
