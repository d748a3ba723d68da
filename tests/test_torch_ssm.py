"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, on the CPU.

Numpy-seeded inputs, the JAX ``mamba_init(PRNGKey)`` weights carried across
by ``convert.params_from_jax``, float32 throughout.  The chunked SSD agrees
with the JAX function and with the naive per-step recurrence (a port of
``tests/test_models_smoke.py:160``) within ``ATOL`` = 1e-4, that test's own
tolerance: exp and sums over up to 32 steps of O(1) terms taken in another
order.  The block's outputs and both cache leaves agree within 1e-5
(``BLOCK_TOL``; outputs of scale ~1 after the gated norm and out_proj).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.models import cache_from_jax, params_from_jax, ssm

ATOL = 1e-4
BLOCK_TOL = 1e-5
# the reduced mamba2's widths: d_model 128 (d_inner 256), 8 heads of 32,
# state 16, conv 4, chunk 16
D, N, P, EXPAND, K_CONV, CHUNK = 128, 16, 32, 2, 4, 16


def _ssd_inputs(B, S, H, Pd, Nd, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, Pd)).astype(np.float32)
    dA = (-np.abs(rng.normal(size=(B, S, H))) * .3).astype(np.float32)
    Bm = rng.normal(size=(B, S, Nd)).astype(np.float32)
    Cm = rng.normal(size=(B, S, Nd)).astype(np.float32)
    return x, dA, Bm, Cm


def _t(*a):
    return [torch.from_numpy(v) for v in a]


def test_ssm_chunked_equals_naive_recurrence():
    """tests/test_models_smoke.py:160 in the port, chunks 8 and 16."""
    B, S, H, Pd, Nd = 2, 32, 3, 4, 8
    x, dA, Bm, Cm = _ssd_inputs(B, S, H, Pd, Nd, 0)
    s = np.zeros((B, H, Pd, Nd))
    ys = []
    for t in range(S):
        s = s * np.exp(dA[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", s, Cm[:, t]))
    y_ref = np.stack(ys, 1)
    for chunk in (8, 16):
        y, fs = ssm.ssd_chunked(*_t(x, dA, Bm, Cm), chunk)
        np.testing.assert_allclose(y.numpy(), y_ref, atol=ATOL)
        np.testing.assert_allclose(fs.numpy(), s, atol=ATOL)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(chunk, with_state):
    B, S, H, Pd, Nd = 2, 48, 4, 8, 16
    x, dA, Bm, Cm = _ssd_inputs(B, S, H, Pd, Nd, chunk)
    s0 = (np.random.default_rng(9).normal(size=(B, H, Pd, Nd))
          .astype(np.float32) if with_state else None)
    yj, fj = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dA, Bm, Cm)), chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    yt, ft = ssm.ssd_chunked(
        *_t(x, dA, Bm, Cm), chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=ATOL)
    with pytest.raises(ValueError, match="not divisible"):
        ssm.ssd_chunked(*_t(x, dA, Bm, Cm), 7)


def test_segsum_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 3, 9)).astype(np.float32)
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(24, 4)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    got = ssm.causal_conv(*_t(x, w, b)).numpy()
    want = np.asarray(jax_ssm.causal_conv(*map(jnp.asarray, (x, w, b))))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # a cross-correlation: out[s] = Σ_i w[:, i] x[s - 3 + i] + b
    np.testing.assert_allclose(got[:, 5], (x[:, 2:6] * w.T).sum(1) + b,
                               atol=1e-5)


def _block(seed, dtype=jnp.float32):
    pj = jax_ssm.mamba_init(jax.random.PRNGKey(seed), D, N, P, EXPAND,
                            K_CONV, dtype)
    return pj, params_from_jax(jax.device_get(pj), device="cpu")


KW = dict(d_state=N, head_dim=P, expand=EXPAND, chunk=CHUNK)


@pytest.mark.parametrize("S", [5, 16, 20])
def test_mamba_prefill_matches_jax(S):
    """S = 16 is one chunk; S = 5 a chunk cut to the sequence; S = 20 two
    chunks of 16 with 12 padded steps (dt = 0: the state carries through)."""
    pj, pt = _block(S)
    x = np.random.default_rng(S).normal(size=(2, S, D)).astype(np.float32)
    oj, cj = jax_ssm.mamba_apply(pj, jnp.asarray(x), **KW)
    ot, ct = ssm.mamba_apply(pt, torch.from_numpy(x), **KW)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    cj = cache_from_jax(jax.device_get({"c": cj}), device="cpu")["c"]
    assert set(ct) == {"state", "conv"}
    for n in ("state", "conv"):
        assert ct[n].shape == cj[n].shape and ct[n].dtype == cj[n].dtype
        np.testing.assert_allclose(ct[n].numpy(), cj[n].numpy(),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL, err_msg=n)


def test_mamba_decode_matches_jax_and_continues_prefill():
    """Prefill 12 tokens, then 6 decode steps in both packages: outputs and
    both cache leaves equal the JAX package's, and the port's decode
    outputs equal its own prefill over all 18 tokens."""
    pj, pt = _block(7)
    S, half = 18, 12
    x = np.random.default_rng(7).normal(size=(2, S, D)).astype(np.float32)
    _, cj = jax_ssm.mamba_apply(pj, jnp.asarray(x[:, :half]), **KW)
    _, ct = ssm.mamba_apply(pt, torch.from_numpy(x[:, :half]), **KW)
    full, _ = ssm.mamba_apply(pt, torch.from_numpy(x), **KW)
    for t in range(half, S):
        oj, cj = jax_ssm.mamba_apply(pj, jnp.asarray(x[:, t:t + 1]),
                                     cache=cj, decode=True, **KW)
        ot, ct = ssm.mamba_apply(pt, torch.from_numpy(x[:, t:t + 1]),
                                 cache=ct, decode=True, **KW)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
        np.testing.assert_allclose(ot.numpy()[:, 0], full.numpy()[:, t],
                                   atol=1e-4, rtol=1e-4)
    for n in ("state", "conv"):
        np.testing.assert_allclose(ct[n].numpy(),
                                   np.asarray(getattr(cj, n)),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL, err_msg=n)
    with pytest.raises(ValueError, match="one token"):
        ssm.mamba_apply(pt, torch.from_numpy(x[:, :2]), cache=ct,
                        decode=True, **KW)


def test_mamba_gradients_are_finite_and_match_jax_grad():
    """The segment sum's −inf entries under autograd: no NaN anywhere, and
    d/d(x, every leaf) of Σ out·w against ``jax.grad`` at S = 20 (padded
    to two chunks), rtol 1e-4."""
    pj, pt = _block(11)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 20, D)).astype(np.float32)
    w = rng.normal(size=(2, 20, D)).astype(np.float32)

    def f(p, x):
        o, _ = jax_ssm.mamba_apply(p, x, **KW)
        return jnp.sum(o * w)

    gpj, gxj = jax.grad(f, argnums=(0, 1))(pj, jnp.asarray(x))
    for t in pt.values():
        t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    o, _ = ssm.mamba_apply(pt, xt, **KW)
    (o * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), rtol=1e-4,
                               atol=1e-5)
    for n, t in pt.items():
        assert torch.isfinite(t.grad).all(), n
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gpj[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_mamba_init_and_cache_init_match_jax():
    want = jax.eval_shape(lambda: jax_ssm.mamba_init(
        jax.random.PRNGKey(0), D, N, P, EXPAND, K_CONV, jnp.bfloat16))
    got = ssm.mamba_init(torch.Generator().manual_seed(0), D, N, P, EXPAND,
                         K_CONV, torch.bfloat16)
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), got)
            == jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want))
    assert float(got["conv_w"].float().std()) == pytest.approx(0.5, rel=0.05)
    assert not got["A_log"].any() and not got["conv_b"].any()
    assert (got["D"] == 1).all() and (got["dt_bias"] == -2).all()
    cj = jax_ssm.mamba_cache_init(3, D, N, P, EXPAND, K_CONV, jnp.bfloat16)
    ct = ssm.mamba_cache_init(3, D, N, P, EXPAND, K_CONV, torch.bfloat16,
                               device="cpu")
    for n in ("state", "conv"):
        assert tuple(ct[n].shape) == getattr(cj, n).shape
        assert str(ct[n].dtype)[6:] == str(getattr(cj, n).dtype)
        assert not ct[n].any()
