"""The port's optimizer and schedules (``repro_torch.optim``) against the JAX
package's ``repro.optim``, on the CPU.

* ``cosine_warmup`` and ``robbins_monro`` at step 0, inside the warm-up, at
  its end, in the middle of the cosine, at its end and past it: both
  packages compute in float32; the port's cosine is numpy's float32 and
  XLA's may round its last bit differently, so rtol 1e-6.
* ``adamw_update`` against the JAX ``adamw_update`` over 3 steps on a tree
  with a 1-D leaf, stacked 2-D leaves and a 3-D leaf, with the global-norm
  clip active (gradients of norm ~20 against a clip of 1) and inactive
  (a clip of 1e3; and ``grad_clip=0``).  Every moment and parameter within
  rtol 1e-6 (atol 1e-9 for the moments near 0): the arithmetic is the JAX
  package's operation for operation, in float32, but the norm's sums run
  in another order (a few ulps).
* In bfloat16 (the LM's training type: bf16 parameters and gradients,
  float32 moments) at lr 1e-2, with the clip active and inactive, the
  parameters bitwise the JAX package's over 3 steps.
* Step 1 of the LM trainer runs at lr 0: every parameter keeps its bits,
  in float32 and bfloat16, and the moments are set.
* The port's ``OptState`` checkpoint restores into the JAX package's
  (``checkpoint.ckpt`` writes the JAX on-disk format, leaves in
  ``jax.tree.flatten``'s order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro.optim import robbins_monro as jax_robbins_monro
from repro_torch.checkpoint import save_checkpoint
from repro_torch.optim import (
    OptState,
    adamw_init,
    adamw_update,
    cosine_warmup,
    robbins_monro,
)
from repro_torch.optim import adamw as adamw_mod

SCHED_RTOL = 1e-6
RTOL, MOMENT_ATOL = 1e-6, 1e-9


@pytest.mark.parametrize("step", [0, 7, 20, 35, 50, 80])
def test_cosine_warmup_matches_jax(step):
    kw = dict(peak_lr=1e-3, warmup=20, total=50)
    want = np.float32(jax_cosine_warmup(jnp.int32(step), **kw))
    got = cosine_warmup(step, **kw)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)
    # a 0-d tensor count gives the same value
    assert cosine_warmup(torch.tensor(step, dtype=torch.int32), **kw) == got


def test_cosine_warmup_is_zero_at_step_0_and_floors_at_the_end():
    assert cosine_warmup(0, peak_lr=1e-3, warmup=20, total=50) == 0.0
    end = cosine_warmup(50, peak_lr=1e-3, warmup=20, total=50)
    assert end == cosine_warmup(500, peak_lr=1e-3, warmup=20, total=50)
    np.testing.assert_allclose(end, 1e-4, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 10, 1000])
def test_robbins_monro_matches_jax(step):
    want = np.float32(jax_robbins_monro(jnp.int32(step)))
    np.testing.assert_allclose(robbins_monro(step), want, rtol=SCHED_RTOL,
                               atol=0)
    want = np.float32(jax_robbins_monro(jnp.int32(step), tau0=64.0,
                                        kappa=0.6))
    np.testing.assert_allclose(robbins_monro(step, tau0=64.0, kappa=0.6),
                               want, rtol=SCHED_RTOL, atol=0)


def _tree(rng, scale=1.0):
    """1-D, stacked 2-D (nblocks, d) and 3-D leaves, as the LM's."""
    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"final_norm": n(6),
            "blocks": {"l0": {"norm1": n(3, 6), "w": n(3, 6, 5)}},
            "lm_head": n(6, 9)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t), tree)


@pytest.mark.parametrize("grad_scale,clip", [(5.0, 1.0), (5.0, 1e3),
                                             (5.0, 0.0), (1e-3, 1.0)],
                         ids=["clipped", "clip-inactive", "no-clip",
                              "small-grads"])
def test_adamw_update_matches_jax(grad_scale, clip):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    pj = jax.tree.map(jnp.asarray, p0)
    oj = jax_adamw_init(pj)
    pt = _to_torch(p0)
    ot = adamw_init(pt)
    for step in range(3):
        g = _tree(rng, grad_scale)
        lr = 1e-2 * (step + 1)
        pj, oj = jax_adamw_update(jax.tree.map(jnp.asarray, g), oj, pj,
                                  lr=lr, grad_clip=clip)
        pt, ot = adamw_update(_to_torch(g), ot, pt, lr=lr, grad_clip=clip)
        assert int(ot.count) == int(oj.count) == step + 1
        for got, want, atol in ((pt, pj, 0.0), (ot.mu, oj.mu, MOMENT_ATOL),
                                (ot.nu, oj.nu, MOMENT_ATOL)):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                a.numpy(), np.asarray(b), rtol=RTOL, atol=atol), got,
                _np(want))


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "clip-inactive"])
def test_adamw_update_bf16_matches_jax(clip):
    """bfloat16 parameters and gradients (the LM's training type) over 3
    steps at lr 1e-2, where an update is about an ulp of a weight of ~1:
    the moments within RTOL, the parameters bitwise JAX's (the float32
    arithmetic is JAX's, rounded to bf16 once a step)."""
    rng = np.random.default_rng(3)

    def bf16(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)

    def to_torch(tree):
        return jax.tree.map(
            lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
                torch.bfloat16), tree)

    pj = bf16(_tree(rng))
    pt = to_torch(pj)
    p0 = jax.tree.map(lambda t: t.clone(), pt)
    oj, ot = jax_adamw_init(pj), adamw_init(pt)
    for step in range(3):
        g = bf16(_tree(rng, 5.0))
        pj, oj = jax_adamw_update(g, oj, pj, lr=1e-2, grad_clip=clip)
        pt, ot = adamw_update(to_torch(g), ot, pt, lr=1e-2, grad_clip=clip)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b, np.float32)), pt, pj)
        for got, want in ((ot.mu, oj.mu), (ot.nu, oj.nu)):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                a.numpy(), np.asarray(b), rtol=RTOL, atol=MOMENT_ATOL),
                got, _np(want))
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(pt))
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: bool((a != b).any()), pt, p0)))


def test_weight_decay_is_by_rank():
    """A zero gradient leaves a 1-D leaf alone and decays every leaf of
    rank >= 2 — the stacked (nblocks, d) norm scales too."""
    rng = np.random.default_rng(1)
    p = _to_torch(_tree(rng))
    before = jax.tree.map(lambda t: t.clone(), p)
    g = jax.tree.map(torch.zeros_like, p)
    opt = adamw_update(g, adamw_init(p), p, lr=0.5, grad_clip=0.0)[1]
    assert torch.equal(p["final_norm"], before["final_norm"])
    for name in ("norm1", "w"):
        got, was = p["blocks"]["l0"][name], before["blocks"]["l0"][name]
        torch.testing.assert_close(got, was * (1 - 0.5 * 0.1), rtol=1e-6,
                                   atol=0)
    assert int(opt.count) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lr_zero_step_keeps_every_parameter_bitwise(dtype):
    rng = np.random.default_rng(2)
    p = jax.tree.map(lambda t: t.to(dtype), _to_torch(_tree(rng)))
    before = jax.tree.map(lambda t: t.clone(), p)
    g = jax.tree.map(lambda t: t.to(dtype), _to_torch(_tree(rng, 3.0)))
    p, opt = adamw_update(g, adamw_init(p), p, lr=cosine_warmup(
        0, peak_lr=1e-3, warmup=20, total=10))
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                         atol=0), p, before)
    assert all(float(m.abs().sum()) > 0
               for m in jax.tree.leaves(opt.mu))
    assert all(m.dtype == torch.float32 for m in jax.tree.leaves(opt.nu))


def test_update_in_chunks_equals_one_chunk(monkeypatch):
    """The chunks change no bit of the elementwise update: without the
    clip (whose norm sums a leaf chunk by chunk, in another order), a leaf
    updated in chunks of 7 elements equals the same leaf updated whole."""
    rng = np.random.default_rng(3)
    p0, grads = _tree(rng), [_tree(rng) for _ in range(2)]
    runs = []
    for chunk in (adamw_mod.CHUNK, 7):
        monkeypatch.setattr(adamw_mod, "CHUNK", chunk)
        p = _to_torch(p0)
        opt = adamw_init(p)
        for g in grads:
            p, opt = adamw_update(_to_torch(g), opt, p, lr=1e-2,
                                  grad_clip=0.0)
        runs.append((p, opt))
    (pa, oa), (pb, ob) = runs
    for a, b in zip(jax.tree.leaves((pa, oa.mu, oa.nu)),
                    jax.tree.leaves((pb, ob.mu, ob.nu))):
        assert torch.equal(a, b)


def test_opt_state_checkpoint_restores_into_jax(tmp_path):
    rng = np.random.default_rng(4)
    p = _to_torch(_tree(rng))
    p, opt = adamw_update(_to_torch(_tree(rng)), adamw_init(p), p, lr=1e-3)
    assert isinstance(opt, OptState)
    save_checkpoint(str(tmp_path), 1, (p, opt))
    like = (jax.tree.map(jnp.asarray, _np(p)),
            jax_adamw_init(jax.tree.map(jnp.asarray, _np(p))))
    step, (pj, oj) = jax_ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 1 and int(oj.count) == 1
    for a, b in zip(jax.tree.leaves((p, opt.mu, opt.nu)),
                    jax.tree.leaves((pj, oj.mu, oj.nu))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
