"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips on a host without a CUDA
device (the decision is made inside the test).  On a GPU host run them without the repository's conftest, which
imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes are odd on purpose: K not a multiple of the 1024-thread CTA, zero
count columns, A above the warp width, and K = 50,000 (``bigmodel``), where
the per-document state leaves shared memory for the global scratch.
Tolerances are chip_smoke.py's: float32 sums over K taken in another order.

The training sweeps (``gs_sweep``, ``scheduled_sweep``) are held against
their plain versions at odd K, A = 1 and A = K, with duplicate words in a
column, with and without the stop-rule phase; they, the PyTorch segment
sums of the trainer (``fold_phi``, ``residuals_from_sweep``,
``scheduler_update_from_sweep``) and a short training run with prefetch on
and off must be bitwise repeatable on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import em, scheduling
from repro_torch.core.types import SchedulerState
from repro_torch.kernels import ops
from repro_torch.kernels.gs_sweep import gs_sweep, gs_sweep_reference
from repro_torch.kernels.scheduled_sweep import (
    scheduled_sweep,
    scheduled_sweep_reference,
)
from repro_torch.kernels.theta_sweep import (
    SMEM_BUDGET,
    quantize_phi,
    theta_sweep,
    theta_sweep_reference,
    word_lane_masks,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(D, L, K, W, A, dev, seed=0):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    est = rng.integers(0, 4, (D, L)).astype(np.float32)   # zero columns
    ev = rng.integers(0, 2, (D, L)).astype(np.float32)
    est[:, -2:] = 0.0                                      # padded tail
    ev[:, -1] = 0.0
    phi = rng.gamma(0.3, 1.0, (W, K)).astype(np.float32)
    phi /= phi.sum(0, keepdims=True)
    theta = rng.gamma(1.0, 1.0, (D, K)).astype(np.float32)
    wt = np.stack([rng.choice(K, A, replace=False) for _ in range(W)]) \
        if A else None
    t = lambda x: None if x is None else torch.from_numpy(x).to(dev)  # noqa
    return t(wid), t(est), t(ev), t(theta), t(phi), \
        (None if wt is None else t(wt.astype(np.int32)))


def _check(got, want):
    for name, a, b, atol in zip(("theta", "est_ll", "ev_ll"), got, want,
                                (1e-4, 1e-3, 1e-3)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=name)


@pytest.mark.parametrize("D,L,K,W,A", [
    (1, 3, 7, 5, 0),
    (5, 17, 1000, 40, 0),
    (9, 8, 1500, 30, 3),
    (4, 6, 2048, 12, 40),
])
@pytest.mark.parametrize("phi_dtype", ["float32", "bfloat16", "int8"])
def test_kernel_matches_plain(cuda, D, L, K, W, A, phi_dtype):
    wid, est, ev, theta, phi, wt = _inputs(D, L, K, W, A, cuda, seed=K)
    q, scale = quantize_phi(phi, phi_dtype)
    kw = dict(alpha_m1=0.01, num_sweeps=4)
    before = theta_sweep.launches
    got = theta_sweep(wid, est, ev, theta, q, wt, scale, **kw)
    torch.cuda.synchronize()
    assert theta_sweep.launches == before + 1
    _check(got, theta_sweep_reference(wid, est, ev, theta, q, wt, scale,
                                      **kw))


def test_global_scratch_path(cuda):
    """K = 50,000 (bigmodel): 3·K floats exceed shared memory, the kernel
    keeps each document's state in a global scratch and agrees all the
    same."""
    K = 50_000
    assert 3 * K * 4 > SMEM_BUDGET
    wid, est, ev, theta, phi, _ = _inputs(6, 9, K, 20, 0, cuda, seed=1)
    kw = dict(alpha_m1=0.01, num_sweeps=3)
    got = theta_sweep(wid, est, ev, theta, phi, **kw)
    torch.cuda.synchronize()
    _check(got, theta_sweep_reference(wid, est, ev, theta, phi, **kw))


def test_bitwise_repeatable_and_batch_invariant(cuda):
    wid, est, ev, theta, phi, _ = _inputs(12, 10, 3000, 50, 0, cuda, seed=2)
    kw = dict(alpha_m1=0.01, num_sweeps=5)
    a = theta_sweep(wid, est, ev, theta, phi, **kw)
    b = theta_sweep(wid, est, ev, theta, phi, **kw)
    part = theta_sweep(wid[3:7].contiguous(), est[3:7].contiguous(),
                       ev[3:7].contiguous(), theta[3:7].contiguous(), phi,
                       **kw)
    for x, y, z in zip(a, b, part):
        assert torch.equal(x, y)
        assert torch.equal(x[3:7], z)


def test_zero_count_documents_inert(cuda):
    wid, est, ev, theta, phi, _ = _inputs(4, 6, 700, 10, 0, cuda, seed=3)
    est[1] = 0.0
    ev[1] = 0.0
    th, e, v = theta_sweep(wid, est, ev, theta, phi, alpha_m1=0.01,
                           num_sweeps=2)
    assert float(th[1].abs().sum()) == 0.0
    assert float(e[1].abs().sum()) == 0.0 and float(v[1].abs().sum()) == 0.0


def test_wrapper_refuses_bad_operands(cuda):
    wid, est, ev, theta, phi, _ = _inputs(2, 3, 16, 4, 0, cuda)
    with pytest.raises(ValueError, match="word_ids"):
        theta_sweep(wid.long(), est, ev, theta, phi, alpha_m1=0.01,
                    num_sweeps=1)
    with pytest.raises(ValueError, match="phi"):
        theta_sweep(wid, est, ev, theta, phi.double(), alpha_m1=0.01,
                    num_sweeps=1)
    with pytest.raises(ValueError, match="contiguous"):
        theta_sweep(wid, est, ev, theta.t().contiguous().t(), phi,
                    alpha_m1=0.01, num_sweeps=1)


@pytest.mark.parametrize("name,value", [("word_ids", 40), ("word_ids", -3),
                                        ("word_topics", 1000)])
def test_infer_refuses_out_of_range_indices(cuda, name, value):
    """The kernel reads φ rows and writes θ̂ lanes at these values without a
    bound check; ops.infer refuses them before any launch."""
    wid, est, ev, theta, phi, wt = _inputs(5, 7, 1000, 40, 4, cuda, seed=5)
    bad = {"word_ids": wid, "word_topics": wt}[name]
    bad[2, 1] = value
    before = theta_sweep.launches
    with pytest.raises(ops.ContractError, match=name):
        ops.infer(wid, est, theta, phi, alpha_m1=0.01, ev_counts=ev,
                  word_topics=wt, max_sweeps=2, check_every=2, device="cuda")
    assert theta_sweep.launches == before


def test_lane_masks_match_kernel_support(cuda):
    """The plain version's lane masks mark exactly the word_topics lanes."""
    _, _, _, _, phi, wt = _inputs(2, 3, 64, 8, 5, cuda)
    m = word_lane_masks(phi, wt)
    assert int(m.sum()) == 8 * 5
    assert bool((m.gather(1, wt.long()) == 1).all())


# ---------------------------------------------------------------------------
# Training sweeps
# ---------------------------------------------------------------------------

def _sweep_inputs(D, L, K, W, A, dev, seed=0):
    """A minibatch with duplicate words in every column (W small), zero
    counts, a trailing padded column, and residual-ranked active sets."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 3).astype(np.float32)
    ptot = phi.sum(0)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    out = [t(wid), t(cnt), t(mu), t(theta), t(phi), t(ptot)]
    if A:
        r = torch.from_numpy(rng.gamma(1.0, 1.0, (W, K)).astype(np.float32))
        wt = scheduling.select_active_topics(r, A)
        act = (rng.random((D, L)) > 0.25) & (cnt > 0)
        out += [wt.to(dev), t(act)]
    return out


SWEEP_KW = dict(alpha_m1=0.01, beta_m1=0.01, wb=2000 * 0.01)


def _check_sweep(got, want):
    names = ("mu", "residual", "theta", "phi_wk", "phi_k")
    for name, a, b in zip(names, got[:5], want[:5]):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5 * scale,
                                   msg=name)
    if want[5] is not None:
        torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("D,L,K,W,A", [
    (7, 9, 13, 5, 0),          # odd K, many duplicates per column
    (33, 6, 1001, 40, 0),      # K not a multiple of the CTA
    (16, 8, 257, 9, 1),        # A = 1
    (10, 5, 48, 6, 48),        # A = K
    (40, 7, 3000, 30, 16),     # stream_1k's A
])
@pytest.mark.parametrize("loglik", [False, True])
def test_sweep_kernels_match_plain(cuda, D, L, K, W, A, loglik):
    args = _sweep_inputs(D, L, K, W, A, cuda, seed=K + A)
    kw = dict(SWEEP_KW, emit_loglik=loglik)
    if A:
        before = scheduled_sweep.launches
        got = scheduled_sweep(*args, **kw)
        torch.cuda.synchronize()
        assert scheduled_sweep.launches == before + 1
        want = scheduled_sweep_reference(*args, **kw)
    else:
        before = gs_sweep.launches
        got = gs_sweep(*args, **kw)
        torch.cuda.synchronize()
        assert gs_sweep.launches == before + 1
        want = gs_sweep_reference(*args, **kw)
    _check_sweep(got, want)
    assert (got[5] is None) == (not loglik)


@pytest.mark.parametrize("A", [0, 4])
def test_sweep_kernels_bitwise_repeatable(cuda, A):
    args = _sweep_inputs(64, 12, 777, 8, A, cuda, seed=3)
    fn = scheduled_sweep if A else gs_sweep
    a = fn(*args, **SWEEP_KW, emit_loglik=True)
    b = fn(*args, **SWEEP_KW, emit_loglik=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("A", [0, 3])
def test_sweep_zero_count_slots_inert(cuda, A):
    """Zero-count tokens add nothing to θ̂, φ̂ or φ̂(k) and carry a zero
    residual; inactive scheduled entries keep μ_old."""
    args = _sweep_inputs(12, 6, 100, 7, A, cuda, seed=5)
    wid, cnt = args[0], args[1]
    cnt[:4] = 0.0
    fn = scheduled_sweep if A else gs_sweep
    mu, res, theta, phi, ptot, _ = fn(*args, **SWEEP_KW)
    assert float(res[cnt == 0].abs().max()) == 0.0
    torch.testing.assert_close(theta[:4], args[3][:4], rtol=0, atol=0)
    torch.testing.assert_close(phi.sum(0), ptot, rtol=1e-5, atol=1e-3)
    if A:
        act = args[7]
        assert torch.equal(mu[~act], args[2][~act])


def test_sweep_refuses_out_of_range_ids(cuda):
    args = _sweep_inputs(5, 4, 64, 6, 0, cuda, seed=7)
    args[0][1, 2] = 6
    before = gs_sweep.launches
    with pytest.raises(ops.ContractError, match="word_ids"):
        ops.sweep(*args, **SWEEP_KW, device="cuda")
    assert gs_sweep.launches == before


def test_segment_sums_bitwise_repeatable(cuda):
    """The trainer's PyTorch segment sums accumulate duplicates in a fixed
    order on the card (atomics would not): two calls, same bits."""
    rng = np.random.default_rng(11)
    D, L, K, W = 256, 32, 500, 40
    wid = torch.from_numpy(rng.integers(0, W, (D, L)).astype(np.int32)).to(
        cuda)
    cnt = torch.from_numpy(rng.integers(0, 5, (D, L)).astype(np.float32)).to(
        cuda)
    mu = torch.rand((D, L, K), device=cuda)
    res = torch.rand((D, L, K), device=cuda)
    r0 = torch.rand((W, K), device=cuda)
    sched = SchedulerState(r0, r0.sum(-1))
    wt = scheduling.select_active_topics(r0, 16)
    for _ in range(2):
        outs = [em.fold_phi(mu, cnt, wid, W)[0],
                scheduling.residuals_from_sweep(res, wid, W).r_wk,
                scheduling.scheduler_update_from_sweep(sched, res, wid,
                                                       wt).r_wk]
        if _:
            for x, y in zip(outs, prev):
                assert torch.equal(x, y)
        prev = outs


def test_training_prefetch_bitwise_on_card(cuda, tmp_path):
    """The streaming trainer on the card: prefetch depth 0 and 1 give the
    same store bits."""
    from repro_torch.core import FOEMTrainer, LDAConfig, ParameterStore
    from repro_torch.data import synthetic_lda_corpus
    from repro_torch.sparse import MinibatchStream

    corpus, _ = synthetic_lda_corpus(120, 150, 5, mean_doc_len=30, seed=11)
    out = []
    for depth in (0, 1):
        cfg = LDAConfig(num_topics=5, vocab_size=150, max_sweeps=6,
                        active_topics=2, ppl_check_every=2)
        store = ParameterStore(str(tmp_path / f"d{depth}"), num_topics=5,
                               vocab_capacity=150, buffer_rows=64)
        tr = FOEMTrainer(cfg, store, seed=0, prefetch_depth=depth,
                         device="cuda")
        ms = tr.fit_stream(iter(MinibatchStream(corpus, 40, seed=0,
                                                epochs=None)), max_steps=4)
        assert len(ms) == 4
        out.append((store.dense_phi().copy(), store.phi_k.copy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
