"""AdamW (decoupled weight decay) over a parameter tree (PyTorch port of
``repro.optim.adamw``).

Moments are float32 whatever the parameters' type (bf16 training).  The
arithmetic is the JAX package's, operation for operation: the global norm
of the gradients over all leaves in float32 and the clip scale
``min(1, clip / max(norm, 1e-12))``; ``m = b1·m + (1−b1)·g``, ``v = b2·v +
(1−b2)·g·g``; bias corrections ``1 − b^count`` from the incremented count;
``step = (m/c1) / (√(v/c2) + eps)``, plus ``weight_decay · p`` for leaves
of rank ≥ 2 only (the rule is by rank, so the stacked (nblocks, d) norm
scales are decayed and ``final_norm`` (d,) is not); ``p = (p − lr·step)``
in float32, rounded to the parameter's type.

Unlike the JAX package's pure function, the update is in place, under
``torch.no_grad``: parameters and moments are written leaf by leaf, in
chunks of at most ``CHUNK`` elements, so no float32 copy of the whole tree
(or of a whole leaf: h2o-danube-3-4b's stacked MLP gate is 3.8 GB in
float32) is ever held.  ``OptState`` is a NamedTuple of (mu, nu, count) in
the JAX package's order, so ``checkpoint.ckpt`` saves and restores it as it
does the JAX one; ``count`` is a 0-d int32 tensor on the CPU.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import tree_flatten, tree_map

#: Elements of a leaf updated at a time (256 MB of float32 a temporary).
CHUNK = 1 << 26


class OptState(NamedTuple):
    mu: Any        # first moment  (float32)
    nu: Any        # second moment (float32)
    count: torch.Tensor


def adamw_init(params) -> OptState:
    """Zero float32 moments beside each leaf (on its device), count 0."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(mu=tree_map(zeros32, params),
                    nu=tree_map(zeros32, params),
                    count=torch.zeros((), dtype=torch.int32))


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def global_norm(grads) -> torch.Tensor:
    """√(Σ over leaves of Σ g²) in float32, the leaves summed in the JAX
    package's order."""
    total = None
    for g in tree_flatten(grads)[0]:
        s = None
        for gc in _chunks(g.contiguous()):
            part = gc.float().square().sum()
            s = part if s is None else s + part
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    grads, state: OptState, params, *,
    lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.1, grad_clip: float = 1.0,
):
    """Returns ``(params, state)``: the parameters and moments updated in
    place and a new count.  ``lr`` is a number (a float, a numpy float32
    from :mod:`.schedules`, or a 0-d tensor)."""
    count = state.count + 1
    lr = float(lr)
    scale = None
    if grad_clip > 0:
        gnorm = global_norm(grads)
        scale = torch.clamp_max(
            torch.full_like(gnorm, grad_clip) / gnorm.clamp_min(1e-12), 1.0)
    n = np.float32(int(count))
    c1 = float(np.float32(1.0) - np.float32(b1) ** n)
    c2 = float(np.float32(1.0) - np.float32(b2) ** n)

    leaves = zip(tree_flatten(grads)[0], tree_flatten(state.mu)[0],
                 tree_flatten(state.nu)[0], tree_flatten(params)[0])
    for g, m, v, p in leaves:
        decay = bool(weight_decay) and p.ndim >= 2   # decay matrices only
        for gc, mc, vc, pc in zip(_chunks(g.contiguous()), _chunks(m),
                                  _chunks(v), _chunks(p)):
            g32 = gc.float() if scale is None else gc.float() * scale
            mc.mul_(b1).add_(g32 * (1 - b1))
            vc.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            step = mc.div(c1).div_(vc.div(c2).sqrt_().add_(eps))
            p32 = pc.float()          # pc itself when it is float32
            if decay:
                step.add_(p32 * weight_decay)
            pc.copy_(p32.sub_(step.mul_(lr)))
    return params, OptState(mu=state.mu, nu=state.nu, count=count)
