"""Pipeline parallelism: a GPipe schedule of microbatches through stages
laid on an axis of ranks (PyTorch port of ``repro.parallel.pipeline``).

The block stack is cut into S contiguous stages, one a rank of the stage
axis (a ``launch.mesh.MeshAxis``); each rank holds its stage's slice of
the stacked stage parameters.  At tick t stage 0 takes microbatch t, every
stage runs its block on what it holds and passes the result to the next
stage with a permute (``collectives.ppermute``).  After M + S − 1 ticks
every microbatch has passed all stages; the last stage's outputs reach
every rank through an all-reduce of the one-hot owner, as in the JAX
package.  M ≥ S microbatches keep the idle share at (S − 1)/(M + S − 1).

The schedule is differentiable, as the JAX function is under
``jax.grad``: the permute's gradient is the reverse permute, the
all-reduce that hands the outputs round (to ranks whose loss is the same)
passes each rank's output gradient through as it is, and the gradient of
the replicated input is summed over the axis.  Every rank runs the same
operations, with its stage's choices made by ``torch.where``, so that
backward runs the same collectives in the same order on every rank.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.parallel.collectives import ppermute


class _Permute(torch.autograd.Function):
    """``collectives.ppermute``; its gradient is the reverse permute."""

    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return ppermute(g.contiguous(), ctx.axis, back), None, None


class _FromOwner(torch.autograd.Function):
    """The sum over the axis of x (non-zero on one rank only): every rank
    then holds the owner's values, and its loss of them is the same one
    loss, so the gradient passes through as it is."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """An input every rank holds alike: the identity, its gradient summed
    over the axis (each rank's holds its own stage's share)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.contiguous())[0], None


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x_microbatches: torch.Tensor, *,
                     axis, num_stages: int) -> torch.Tensor:
    """The GPipe forward over ``axis`` (``axis.size == num_stages``).

    ``stage_params`` is this rank's stage's parameters, ``x_microbatches``
    (M, mb, …) stage 0's inputs (every rank passes them); ``stage_fn(params,
    x)`` maps an (mb, …) microbatch to one of the same shape.  Returns the
    (M, mb, …) outputs of the last stage on every rank."""
    M, S = x_microbatches.shape[0], num_stages
    if axis.size != S:
        raise ValueError(f"{S} stages on an axis of {axis.size} ranks")
    stage = axis.index
    perm = [(i, (i + 1) % S) for i in range(S)]
    x_microbatches = _Replicated.apply(x_microbatches, axis)
    buf = torch.zeros_like(x_microbatches[0])
    outs = [torch.zeros_like(buf) for _ in range(M)]
    first = torch.tensor(stage == 0, device=buf.device)
    for t in range(M + S - 1):
        injected = torch.where(first & (t < M),
                               x_microbatches[min(t, M - 1)], buf)
        y = stage_fn(stage_params, injected)
        # the last stage records microbatch t − (S − 1) when it is one
        out_idx = t - (S - 1)
        slot = min(max(out_idx, 0), M - 1)
        valid = torch.tensor(stage == S - 1 and 0 <= out_idx < M,
                             device=buf.device)
        outs[slot] = torch.where(valid, y, outs[slot])
        buf = _Permute.apply(y, axis, perm)
    owner = float(stage == S - 1)
    return _FromOwner.apply(torch.stack(outs, 0) * owner, axis)


def make_pipelined_apply(stage_fn: Callable, axis, *, num_stages: int,
                         num_microbatches: int):
    """A per-stage block function made into the pipelined forward of the
    whole model over the stage ``axis``: ``run(stage_params, x)`` takes
    this rank's block of the stacked stage parameters (each leaf's leading
    stage axis of 1, as ``shard_map`` hands a device its block) and the
    (B, …) batch every rank holds, cut into ``num_microbatches``
    microbatches, and returns the (B, …) outputs on every rank."""

    def run(stage_params, x):
        local = tree_map(lambda a: a[0], stage_params)
        M = num_microbatches
        xm = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        out = pipeline_forward(stage_fn, local, xm, axis=axis,
                               num_stages=num_stages)
        return out.reshape(tuple(x.shape[:1]) + tuple(out.shape[2:]))

    return run

