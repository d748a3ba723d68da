"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

The JAX ``moe_init(PRNGKey)`` weights are carried across by
``convert.params_from_jax``; the tokens are numpy-seeded.  Float32
throughout: the outputs agree within ``ATOL`` = 1e-5 of their largest
magnitude (sums of a few hundred products taken in another order, ~1e-7
relative each; the JAX initialiser scales the expert weights by
1/√E — its fan-in is the expert axis —, so the outputs reach ~10²).

Near-ties: the router's logits are float32 sums taken in another order in
the two packages (~1e-7 apart, which moves a probability of ~1/E by
~1e-8), so where a token's k-th and (k+1)-th probabilities lie within
``NEAR_TIE`` = 1e-6 (a hundred times that) the two may pick different
experts —
an O(1) change of that token's output that is no fault of either.  The
cross-package checks find such tokens from the JAX package's probabilities,
report and exclude them, and assert that they stay rare (at most one token
in ``RARE`` = 500).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe, params_from_jax

ATOL = 1e-5
NEAR_TIE, RARE = 1e-6, 500


def _layer(seed, D, F, E, shared, shared_ff=0):
    pj = jax_moe.moe_init(jax.random.PRNGKey(seed), D, F, E, shared,
                          shared_ff, jnp.float32)
    return pj, params_from_jax(jax.device_get(pj), device="cpu")


def _near_ties(pj, x, k):
    """Tokens whose k-th and (k+1)-th routing probabilities (the JAX
    package's float32 softmax) lie within NEAR_TIE."""
    xt = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt) @ pj["router"], -1))
    top = -np.sort(-probs, -1)
    if k >= probs.shape[1]:
        return np.zeros(len(xt), bool)
    return top[:, k - 1] - top[:, k] < NEAR_TIE


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("E,k", [(4, 2), (60, 4)])
def test_moe_apply_matches_jax(E, k, shared):
    """The TP form against the JAX ``moe_apply`` on 2 × 256 tokens, with
    and without the shared expert; padded (60 → 64) and unpadded expert
    counts."""
    D, F = 64, 96
    pj, pt = _layer(E + shared, D, F, E, shared, 128)
    x = np.random.default_rng(E).normal(size=(2, 256, D)).astype(np.float32)
    want = np.asarray(jax_moe.moe_apply(pj, jnp.asarray(x),
                                        experts_per_token=k))
    got = moe.moe_apply(pt, torch.from_numpy(x), experts_per_token=k)
    assert got.shape == x.shape and got.dtype == torch.float32
    tie = _near_ties(pj, x, k)
    assert tie.sum() <= max(1, tie.size // RARE), (
        f"{tie.sum()} near-tie tokens of {tie.size}")
    if tie.any():
        print(f"excluded near-tie tokens: {np.flatnonzero(tie)}")
    np.testing.assert_allclose(got.numpy().reshape(-1, D)[~tie],
                               want.reshape(-1, D)[~tie], rtol=0,
                               atol=ATOL * np.abs(want).max())


def test_moe_routing_against_naive_reference():
    """tests/test_models_smoke.py:129 in the port: sort + grouped product
    equals a per-token loop over the chosen experts."""
    rng = np.random.default_rng(0)
    D, F, E, k = 16, 32, 6, 2
    _, p = _layer(0, D, F, E, 0)
    x = rng.normal(size=(2, 8, D)).astype(np.float32)
    out = moe.moe_apply(p, torch.from_numpy(x), experts_per_token=k)
    xt = x.reshape(-1, D)
    logits = xt @ p["router"].numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    topi = np.argsort(-probs, axis=-1)[:, :k]
    ref = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        ws = probs[t, topi[t]]
        ws = ws / ws.sum()
        for j, e in enumerate(topi[t]):
            gate = xt[t] @ p["w_gate"][e].numpy()
            up = xt[t] @ p["w_up"][e].numpy()
            act = gate / (1 + np.exp(-gate)) * up
            ref[t] += ws[j] * (act @ p["w_down"][e].numpy())
    np.testing.assert_allclose(out.numpy().reshape(-1, D), ref, atol=2e-4)


def test_moe_init_tree_padding_and_types():
    """The JAX leaves' names, shapes and types; the padded experts' weights
    are zero and the router keeps the logical width."""
    assert [moe.pad_experts(e) for e in (4, 16, 60, 128)] == [16, 16, 64,
                                                              128]
    want = jax.eval_shape(lambda: jax_moe.moe_init(
        jax.random.PRNGKey(0), 32, 48, 60, 4, 64, jnp.bfloat16))
    got = moe.moe_init(torch.Generator().manual_seed(0), 32, 48, 60, 4, 64,
                       torch.bfloat16)
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), got)
            == jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want))
    assert got["router"].dtype == torch.float32
    for n in ("w_gate", "w_up", "w_down"):
        assert not got[n][60:].any() and got[n][:60].abs().sum() > 0
    # the JAX initialiser's scale: normal × 1/√fan_in, fan_in = shape[0]
    assert float(got["router"].std()) == pytest.approx(32 ** -0.5, rel=0.05)


def test_padded_experts_are_never_routed():
    """Routing picks logical experts only, whatever the tokens: the groups
    of the padded experts stay empty, and zeroing their weights' rows (or
    filling them with NaN) changes no output."""
    D, F, E, k = 32, 48, 4, 2
    _, p = _layer(1, D, F, E, 1, 64)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 50, D)).astype(np.float32) * 5)
    _, topi = moe.route(p["router"], x.reshape(-1, D), k)
    assert int(topi.max()) < E
    sizes = torch.bincount(topi.reshape(-1), minlength=moe.pad_experts(E))
    assert not sizes[E:].any() and int(sizes.sum()) == 150 * k
    base = moe.moe_apply(p, x, experts_per_token=k)
    poisoned = {n: t.clone() for n, t in p.items() if n != "shared"}
    poisoned["shared"] = p["shared"]
    for n in ("w_gate", "w_up", "w_down"):
        poisoned[n][E:] = float("nan")
    assert torch.equal(moe.moe_apply(poisoned, x, experts_per_token=k), base)


def test_moe_apply_is_bitwise_repeatable():
    """Two calls give the same bits: no atomics in the combine."""
    _, p = _layer(2, 64, 96, 60, 1, 128)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 128, 64)).astype(np.float32))
    a = moe.moe_apply(p, x, experts_per_token=4)
    b = moe.moe_apply(p, x, experts_per_token=4)
    assert torch.equal(a, b)


def test_moe_gradients_match_jax_grad():
    """d/d(x, every leaf) of Σ y·w_out through the TP form against
    ``jax.grad`` of the JAX ``moe_apply`` (rtol 1e-4)."""
    D, F, E, k = 32, 48, 6, 2
    pj, pt = _layer(3, D, F, E, 1, 64)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, D)).astype(np.float32)
    w_out = rng.normal(size=(2, 40, D)).astype(np.float32)
    assert not _near_ties(pj, x, k).any()

    def f(p, x):
        return jnp.sum(jax_moe.moe_apply(p, x, experts_per_token=k) * w_out)

    gpj, gxj = jax.grad(f, argnums=(0, 1))(pj, jnp.asarray(x))
    leaves = {n: t.requires_grad_() for n, t in pt.items() if n != "shared"}
    shared = {n: t.requires_grad_() for n, t in pt["shared"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = moe.moe_apply({**leaves, "shared": shared}, xt, experts_per_token=k)
    (y * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), rtol=1e-4,
                               atol=1e-5)
    for n, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gpj[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    for n, t in shared.items():
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(gpj["shared"][n]), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_sort_pairs_is_stable_and_combine_inverts_it():
    topi = torch.tensor([[2, 0], [0, 2], [1, 2], [2, 1]])
    order, inv = moe.sort_pairs(topi)
    # pairs t·k + j by expert, ties in pair order
    assert order.tolist() == [1, 2, 4, 7, 0, 3, 5, 6]
    assert torch.equal(order[inv], torch.arange(8))
    rows = torch.arange(8, dtype=torch.float32)[:, None].expand(8, 3)
    y = moe.combine(rows.index_select(0, order), inv, 2)
    assert y[:, 0].tolist() == [0 + 1, 2 + 3, 4 + 5, 6 + 7]
