"""The port's two E-step kernels' plain versions vs the JAX package's TPU
kernels, on the CPU.

The same numpy-seeded inputs go through the JAX package's
``fused_estep_pallas`` / ``topk_estep_pallas`` in interpret mode (as
``tests/test_kernels.py`` runs them) and the port's
``foem_estep.fused_estep`` / ``topk_estep.topk_estep`` on CPU tensors, which
run the plain versions.  Tolerance: atol 1e-6, the reference's own
kernel-vs-oracle tolerance (``tests/test_kernels.py``): μ is a probability
and the residuals are a few tokens times |Δμ|, and the two sides take the
same float32 operations, only the sum over K in another order.

Cases: with and without the eq. 13 exclusion, ragged T (the TPU wrapper
pads it to the token block), zero-count rows, θ̂ in groups of G tokens
against (T, K) rows (bitwise), pad lanes and inactive tokens; the pad-lane rule
where the TPU kernel and ``ref.topk_estep_ref`` part, and their agreement
without pad lanes; the eager contracts of ``ops.fused_estep`` /
``ops.topk_estep``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.foem_estep import fused_estep_pallas
from repro.kernels.topk_estep import topk_estep_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.foem_estep import (
    REG_MAX_K,
    EstepPath,
    estep_path,
    fused_estep,
    fused_estep_reference,
    tokens_per_row,
)
from repro_torch.kernels.topk_estep import topk_estep, topk_estep_reference

ATOL = 1e-6
KW = dict(alpha_m1=0.01, beta_m1=0.01, wb=0.01 * 5000)


def _estep_inputs(T, K, seed, G=1, zero_rows=0):
    rng = np.random.default_rng(seed)
    th = rng.gamma(2.0, 1.0, (T // G, K)).astype(np.float32)
    ph = rng.gamma(2.0, 1.0, (T, K)).astype(np.float32)
    pt = (rng.gamma(5.0, 1.0, K) + 50).astype(np.float32)
    mu_old = rng.dirichlet(np.ones(K), T).astype(np.float32)
    cnt = rng.integers(1, 5, T).astype(np.float32)
    cnt[:zero_rows] = 0.0
    ex = cnt[:, None] * mu_old
    return th, ph, pt, ex, mu_old, cnt


def _jax_estep(th, ph, pt, ex, mu_old, cnt, use_exclude, block):
    j = jnp.asarray
    mu, res = fused_estep_pallas(
        j(th), j(ph), j(pt), j(ex) if use_exclude else None, j(mu_old),
        j(cnt), **KW, use_exclude=use_exclude, block_tokens=block,
        interpret=True)
    return np.asarray(mu), np.asarray(res)


@pytest.mark.parametrize("T,K,block,zero_rows", [
    (32, 64, 8, 0),
    (33, 40, 16, 0),       # ragged T, K off the 128-lane tile
    (24, 96, 8, 5),        # zero-count rows
])
@pytest.mark.parametrize("use_exclude", [False, True])
def test_fused_estep_matches_tpu_kernel(T, K, block, zero_rows, use_exclude):
    th, ph, pt, ex, mu_old, cnt = _estep_inputs(T, K, T + K,
                                                zero_rows=zero_rows)
    want_mu, want_res = _jax_estep(th, ph, pt, ex, mu_old, cnt, use_exclude,
                                   block)
    t = torch.from_numpy
    before = fused_estep.launches
    mu, res = fused_estep(t(th), t(ph), t(pt), t(ex) if use_exclude else None,
                          t(mu_old), t(cnt), **KW)
    assert fused_estep.launches == before        # the CPU runs the plain one
    np.testing.assert_allclose(mu.numpy(), want_mu, atol=ATOL)
    np.testing.assert_allclose(res.numpy(), want_res, atol=ATOL)
    assert float(res[:zero_rows].abs().sum()) == 0.0
    np.testing.assert_allclose(mu.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("T,G,use_exclude", [(24, 8, True), (30, 6, False),
                                            (35, 5, True)])
def test_grouped_theta_equals_expanded_rows(T, G, use_exclude):
    """θ̂ in groups of G consecutive tokens gives the bits of the expanded
    (T, K) rows, and matches the TPU kernel fed the expanded rows."""
    K = 48
    th, ph, pt, ex, mu_old, cnt = _estep_inputs(T, K, 7 + T, G=G)
    full = np.repeat(th, G, axis=0)
    t = torch.from_numpy
    ex_t = t(ex) if use_exclude else None
    grouped = fused_estep(t(th), t(ph), t(pt), ex_t, t(mu_old), t(cnt), **KW)
    expanded = fused_estep(t(full), t(ph), t(pt), ex_t, t(mu_old), t(cnt),
                           **KW)
    for a, b in zip(grouped, expanded):
        assert torch.equal(a, b)
    want_mu, want_res = _jax_estep(full, ph, pt, ex, mu_old, cnt,
                                   use_exclude, 8)
    np.testing.assert_allclose(grouped[0].numpy(), want_mu, atol=ATOL)
    np.testing.assert_allclose(grouped[1].numpy(), want_res, atol=ATOL)


def test_fused_estep_without_mu_old_skips_the_residual():
    th, ph, pt, ex, mu_old, cnt = _estep_inputs(20, 32, 3)
    t = torch.from_numpy
    mu, res = fused_estep(t(th), t(ph), t(pt), t(ex), None, None, **KW)
    assert res is None
    assert torch.equal(mu, fused_estep(t(th), t(ph), t(pt), t(ex), t(mu_old),
                                       t(cnt), **KW)[0])


def test_fused_estep_rows_do_not_depend_on_batch_mates():
    th, ph, pt, ex, mu_old, cnt = _estep_inputs(40, 56, 9)
    t = torch.from_numpy
    full = fused_estep(t(th), t(ph), t(pt), t(ex), t(mu_old), t(cnt), **KW)
    part = fused_estep(t(th[:13]), t(ph[:13]), t(pt), t(ex[:13]),
                       t(mu_old[:13]), t(cnt[:13]), **KW)
    for a, b in zip(part, full):
        assert torch.equal(a, b[:13])


def test_tokens_per_row():
    assert tokens_per_row(12, 12) == 1
    assert tokens_per_row(3, 12) == 4
    assert tokens_per_row(0, 0) == 1
    with pytest.raises(ValueError):
        tokens_per_row(5, 12)
    with pytest.raises(ValueError):
        tokens_per_row(0, 4)


@pytest.mark.parametrize("K,off,want", [
    (10_000, 0, EstepPath("registers", 0)),    # stream_1k: 16-byte lanes
    (10_000, 1, EstepPath("registers", 1)),    # an unaligned base: scalar
    (10_001, 0, EstepPath("registers", 1)),    # K % 4 != 0: scalar
    (7, 0, EstepPath("registers", 1)),
    (4096, 0, EstepPath("registers", 0)),
    (REG_MAX_K, 0, EstepPath("registers", 0)),
    (REG_MAX_K + 4, 0, EstepPath("two-pass", 2)),
    (50_000, 0, EstepPath("two-pass", 2)),     # bigmodel
])
def test_estep_path_by_width_and_alignment(K, off, want):
    """The register path up to 10,240 lanes, 16-byte lanes only when
    K % 4 == 0 and every operand is 16-byte aligned; the two-pass path past
    the register bound.  Absent operands do not count."""
    buf = torch.zeros(K + 8)
    x = buf[off:off + K]
    assert estep_path(K, (x, None, buf)) == want
    assert x.data_ptr() % 16 == (4 * off) % 16


# ---------------------------------------------------------------------------
# topk_estep
# ---------------------------------------------------------------------------

def _topk_inputs(T, A, seed, pad_lanes=True):
    rng = np.random.default_rng(seed)
    th = (rng.gamma(2.0, 1.0, (T, A)) + 1).astype(np.float32)
    ph = (rng.gamma(2.0, 1.0, (T, A)) + 1).astype(np.float32)
    pt = (rng.gamma(5.0, 1.0, (T, A)) + 50).astype(np.float32)
    mu = (rng.dirichlet(np.ones(A), T) * 0.6).astype(np.float32)
    cnt = rng.integers(1, 4, T).astype(np.float32)
    cnt[:2] = 0.0
    act = rng.random(T) > 0.4
    if pad_lanes:
        # lanes with no previous mass and no θ̂ mass: the TPU wrapper's
        # padding, and real lanes of a word a document never touched
        lanes = rng.random((T, A)) < 0.2
        mu[lanes] = 0.0
        th[lanes] = 0.0
        mu[3] = 0.0                 # a token whose lanes are all pad lanes
        th[3] = 0.0
    return th, ph, pt, mu, cnt, act


@pytest.mark.parametrize("T,A,block", [(32, 8, 16), (45, 16, 16),
                                       (64, 3, 32), (20, 40, 8)])
def test_topk_estep_matches_tpu_kernel(T, A, block):
    args = _topk_inputs(T, A, T + A)
    j = [jnp.asarray(x) for x in args]
    want = topk_estep_pallas(*j, **KW, block_tokens=block, interpret=True)
    before = topk_estep.launches
    got = topk_estep(*map(torch.from_numpy, args), **KW)
    assert topk_estep.launches == before
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    mu, delta = got
    act = args[5]
    np.testing.assert_array_equal(mu[~act].numpy(), args[3][~act])
    assert float(delta[~act].abs().max()) == 0.0
    assert float(delta[:2].abs().max()) == 0.0          # zero counts
    # eq. 38: an active token keeps its previous active mass
    keep = act & (args[3].sum(-1) > 0)
    np.testing.assert_allclose(mu.sum(-1).numpy()[keep],
                               args[3].sum(-1)[keep], rtol=1e-5)


def test_pad_lane_rule_parts_from_the_jax_oracle():
    """The TPU kernel (and the port) zero a lane with μ_prev ≤ 0 and θ̂ ≤ 0;
    ``ref.topk_estep_ref`` does not and hands it renorm mass.  Without such
    a lane the two agree."""
    T, A = 6, 4
    th, ph, pt, mu, cnt, _ = _topk_inputs(T, A, 1, pad_lanes=False)
    act = np.ones(T, bool)
    mu[2, 1] = 0.0                  # the constructed pad lane
    th[2, 1] = 0.0
    args = (th, ph, pt, mu, cnt, act)
    port = topk_estep(*map(torch.from_numpy, args), **KW)
    oracle = ref.topk_estep_ref(*map(jnp.asarray, args), KW["alpha_m1"],
                                KW["beta_m1"], KW["wb"])
    tpu = topk_estep_pallas(*map(jnp.asarray, args), **KW, block_tokens=8,
                            interpret=True)
    assert float(port[0][2, 1]) == 0.0 == float(tpu[0][2, 1])
    assert float(oracle[0][2, 1]) > 1e-4
    assert abs(float(oracle[0][2, 0]) - float(port[0][2, 0])) > 1e-5
    rest = np.arange(T) != 2
    for a, b, c in zip(port, oracle, tpu):
        np.testing.assert_allclose(a.numpy()[rest], np.asarray(b)[rest],
                                   atol=ATOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=ATOL)


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def test_ops_dispatch_matches_the_wrappers():
    th, ph, pt, ex, mu_old, cnt = _estep_inputs(24, 32, 5, G=4)
    t = torch.from_numpy
    a = ops.fused_estep(t(th), t(ph), t(pt), t(ex), t(mu_old), t(cnt), **KW)
    b = fused_estep_reference(t(th), t(ph), t(pt), t(ex), t(mu_old), t(cnt),
                              **KW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    args = [torch.from_numpy(x) for x in _topk_inputs(16, 5, 2)]
    for x, y in zip(ops.topk_estep(*args, **KW),
                    topk_estep_reference(*args, **KW)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["phi_rank", "theta_rows", "phi_tot",
                                  "exclude", "counts", "dtype", "device"])
def test_fused_estep_contracts(case):
    th, ph, pt, ex, mu_old, cnt = map(torch.from_numpy,
                                      _estep_inputs(12, 8, 4))
    args = dict(theta_rows=th, phi_rows=ph, phi_tot=pt, exclude=ex,
                mu_old=mu_old, counts=cnt)
    if case == "phi_rank":
        args["phi_rows"] = ph[None]
    elif case == "theta_rows":
        args["theta_rows"] = th[:5]              # 5 rows do not divide 12
    elif case == "phi_tot":
        args["phi_tot"] = pt[:-1]
    elif case == "exclude":
        args["exclude"] = ex[:-1]
    elif case == "counts":
        args["counts"] = None
    elif case == "dtype":
        args["exclude"] = ex.double()
    else:
        args["phi_tot"] = pt.to("meta")
    with pytest.raises(ops.ContractError):
        ops.fused_estep(*args.values(), **KW)


@pytest.mark.parametrize("case", ["rank", "slab", "counts", "active",
                                  "dtype"])
def test_topk_estep_contracts(case):
    args = [torch.from_numpy(x) for x in _topk_inputs(10, 4, 6)]
    if case == "rank":
        args[3] = args[3][:, 0]
    elif case == "slab":
        args[1] = args[1][:, :3]
    elif case == "counts":
        args[4] = args[4][:-1]
    elif case == "active":
        args[5] = args[5].float()
    else:
        args[0] = args[0].double()
    with pytest.raises(ops.ContractError):
        ops.topk_estep(*args, **KW)


def test_wrappers_refuse_devices_without_a_kernel():
    t = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_estep(t, t, t[0], None, None, None, **KW)
    with pytest.raises(ValueError, match="cuda or cpu"):
        topk_estep(t, t, t, t, t[:, 0], t[:, 0].bool(), **KW)
