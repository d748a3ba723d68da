"""Learning-rate schedules: cosine+warmup (LM path) and Robbins–Monro (EM).

The port of ``repro.optim.schedules``: the same float32 arithmetic, on
the host in numpy float32 (``step`` is an int, a numpy integer or a 0-d
tensor), so a schedule's value costs the device nothing.  Each returns a
numpy float32.
"""
from __future__ import annotations

import numpy as np

f32 = np.float32


def _step(step) -> np.float32:
    return f32(float(step))


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> np.float32:
    """``peak_lr · step / warmup`` below ``warmup``, then a cosine from
    ``peak_lr`` down to ``floor · peak_lr`` at ``total`` (held after)."""
    s = _step(step)
    warm = f32(peak_lr) * s / f32(max(warmup, 1))
    prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5)
                          * (f32(1.0) + np.cos(f32(np.pi) * prog)))
    return warm if s < f32(warmup) else cos


def robbins_monro(step, *, tau0: float = 1.0, kappa: float = 0.9
                  ) -> np.float32:
    """paper eq. 18: ρ_s = (τ₀ + s)^(−κ), κ ∈ (0.5, 1]."""
    return (f32(tau0) + _step(step)) ** f32(-kappa)
