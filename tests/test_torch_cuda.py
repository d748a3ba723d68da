"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips on a host without a CUDA
device (the decision is made inside the test).  On a GPU host run them without the repository's conftest, which
imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes are odd on purpose: K not a multiple of the 1024-thread CTA, zero
count columns, A above the warp width, and K = 50,000 (``bigmodel``), where
the per-document state leaves shared memory for the global scratch.
Tolerances are chip_smoke.py's: float32 sums over K taken in another order.
Host threads that launch the register path at different lengths at once (a
thread-backend replica pool) all launch, each with the bits of its launch
made alone.

The training sweeps (``gs_sweep``, ``scheduled_sweep``) are held against
their plain versions at odd K, A = 1 and A = K, with duplicate words in a
column, with and without the stop-rule phase; they, the PyTorch segment
sums of the trainer (``fold_phi``, ``residuals_from_sweep``,
``scheduler_update_from_sweep``) and a short training run with prefetch on
and off must be bitwise repeatable on the card.

The sharded sweep's kernels (``sharded_probe``, ``sharded_fold``) are held
against their plain versions at an odd shard width K/mp, A/mp = 1 and
A/mp = K/mp, with duplicate words in a column and injected cross-shard
remainders; two launches give the same bits; with remainder 0 the fold is
the ``gs_sweep``/``scheduled_sweep`` kernel.  The persistent column loop of
``scheduled_sweep`` and ``sharded_fold`` (both forms) is held against the
plain versions, and repeated bitwise, at its edges: a column whose
documents all share one word, a column with no live token, no active token
at all, A = 1 and A = K, D·L·K % 4 ≠ 0 and an unaligned μ (the streaming
pass's scalar paths), and more documents than the card holds CTAs.

The E-step kernels (``fused_estep``, ``topk_estep``) are held against their
plain versions at odd K (10,001) and A ∈ {1, 16, 32, 40}, with and without
the exclusion and the residual, θ̂ in G-token groups, pad lanes and
inactive tokens; two launches give the same bits and a row's bits do not
depend on T.  The block loop of the blocked and ``"scan"`` scheduled
sweeps (``blocked_sweep``) is held against its plain version at B = L, a
ragged B and B = 1, A = 1, A = K and A > 32, one word in the whole batch,
topics shared within a document's block, pad lanes, zero-count and
inactive tokens and more documents than the card holds CTAs: one loop
launch a sweep, the same bits from two launches, inputs untouched.  The
coarse-block and ``"scan"`` sweeps and SEM repeat bitwise on the card
(their folds take fixed orders, not atomics), and the blocked and SEM
trainers give the same store bits with prefetch on and off.

The attention kernel (``flash_attention``) is held against its plain
version at head dims 17, 32, 120 and 128, Sq = 1 (decode, up to an 8,192-
slot cache, and a single KV head), ragged Sq and Sk, Sq·G at 16 and 17
(the decode and prefill forms of the bf16 path), a sliding window, MQA,
non-causal and unaligned bases (the bf16 path's plain-load staging), in
float32 and bfloat16; two launches give the same bits and a query row's
bits do not depend on Sq; the reduced granite and danube LMs' prefill and
decode on the card agree with the CPU's, in float32 and bfloat16.  The
forward's output bits do not depend on whether it also writes each row's
log-sum-exp, which agrees with the plain version's.  The attention backward
kernels (``flash_attention_backward``) are held against ``torch.autograd``
of the plain attention in float32 and bfloat16, with GQA, MQA, a window,
a window shorter than one 128-key tile, non-causal rows, ragged tiles, Sq <
Sk with q_offset = Sk − Sq, danube's grouping at S = 1,024 and d ∈ {17, 32,
64, 100, 120, 128} (17 and 100: rows that are not 16-byte aligned, the bf16
path's plain-load staging), two launches giving the same bits; ``ops.attention`` under autograd on the card gives
wq, wk, wv and wo gradients (the CPU's within the float32 tolerance), and
the reduced LMs' ``loss_fn`` and every gradient leaf on the card agree
with the CPU's.

The baselines' two ``fused_estep`` input forms (OVB: exp Ψ inputs with
a = b = c = 0; SCVB: a = α, b = β, c = Wβ) are held against the plain
version on every kernel path; OVB, SCVB and OGS steps on the card agree
with the CPU (OGS's sampled topics bit for bit) and repeat bitwise; the
serving engine's documents on the card equal bitwise the same documents in
another packing, and alone.

The lifelong path on the card: a trainer publishing snapshots while the
engine serves from them gives the same store bits and snapshot crcs as the
same training without traffic; a latched refresh step launches
``gs_sweep`` ``refresh_extra_sweeps`` more times than a plain step; an
int8-subscribed server's θ is within 0.05 of the f32 server's.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitizer import sum_order_bound
from repro_torch.core import em, foem, scheduling, sem
from repro_torch.core.types import (
    GlobalStats,
    LDAConfig,
    LocalState,
    MinibatchData,
    SchedulerState,
)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
)
from repro_torch.kernels.foem_estep import (
    estep_path,
    fused_estep,
    fused_estep_reference,
)
from repro_torch.kernels.gs_sweep import (
    GROUP_DOCS,
    REG_MAX_K,
    dense_path,
    gs_sweep,
    gs_sweep_reference,
    sweep_loglik,
    sweep_loglik_partials,
    token_loglik,
)
from repro_torch.kernels.scheduled_sweep import (
    scheduled_sweep,
    scheduled_sweep_reference,
)
from repro_torch.kernels.sharded_sweep import (
    probe_path,
    sharded_fold,
    sharded_fold_reference,
    sharded_probe,
    sharded_probe_reference,
)
from repro_torch.kernels.theta_sweep import (
    SMEM_BUDGET,
    quantize_phi,
    sweep_path,
    theta_sweep,
    theta_sweep_reference,
    word_lane_masks,
)
from repro_torch.kernels.topk_estep import (
    block_width,
    blocked_sweep,
    blocked_sweep_reference,
    topk_estep,
    topk_estep_reference,
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


def _theta_call(wid, est, ev, theta, phi, wt, scale, sweeps=4):
    kw = dict(alpha_m1=0.01, num_sweeps=sweeps)
    got = theta_sweep(wid, est, ev, theta, phi, wt, scale, **kw)
    torch.cuda.synchronize()
    _check(got, theta_sweep_reference(wid, est, ev, theta, phi, wt, scale,
                                      **kw))
    again = theta_sweep(wid, est, ev, theta, phi, wt, scale, **kw)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    return got


@pytest.mark.parametrize("phi_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("K,code", [(10_000, 0), (10_001, 1), (10_240, 0)])
def test_register_paths_match_plain(cuda, phi_dtype, K, code):
    """The register paths at the serving width, with rows that are 16-byte
    aligned (K = 10,000) and rows that are not (K = 10,001: the TMA copies
    the aligned span and the lanes are read one by one)."""
    wid, est, ev, theta, phi, _ = _inputs(6, 40, K, 30, 0, cuda, seed=K)
    q, scale = quantize_phi(phi, phi_dtype)
    path = sweep_path(K, 0, 40, q.element_size(), q.data_ptr())
    assert (path.kind, path.code) == ("registers", code)
    _theta_call(wid, est, ev, theta, q, None, scale)


def test_threads_at_different_lengths_launch_together(cuda):
    """Host threads launch the register path at different bucket lengths at
    once, as a thread-backend replica pool does: the ring's shared memory
    differs with L, and no thread's launch may find the kernel's opt-in
    lowered by another's (too many resources requested for launch); every
    launch gives the bits of the same launch made alone."""
    from concurrent.futures import ThreadPoolExecutor

    D, K, rounds = 8, 1000, 200
    lengths = (16, 64, 160, 256)
    runs = []
    for L in lengths:
        wid, est, ev, theta, phi, _ = _inputs(D, L, K, 50, 0, cuda, seed=L)
        args = (wid, est, ev, theta, phi)
        want = theta_sweep(*args, alpha_m1=0.01, num_sweeps=2)
        runs.append((args, want))
    smem = {sweep_path(K, 0, L, 4, runs[0][0][4].data_ptr()).smem
            for L in lengths}
    assert len(smem) == len(lengths)
    torch.cuda.synchronize()

    def hammer(run):
        args, want = run
        got = [theta_sweep(*args, alpha_m1=0.01, num_sweeps=2)
               for _ in range(rounds)]
        torch.cuda.synchronize()
        return all(torch.equal(x, y) for g in got for x, y in zip(g, want))

    with ThreadPoolExecutor(len(lengths)) as pool:
        same = list(pool.map(hammer, runs))
    assert same == [True] * len(lengths)


def test_launch_counts_exact_under_threads(cuda):
    """4 host threads × 200 launches of one wrapper, started together
    against a library whose ctypes set-up is not done yet (the threads
    race into ``build.load``): every launch succeeds with the bits of the
    same launch made alone, and the counter reads exactly 800 more."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    threads, rounds = 4, 200
    q, k, v = _attn_inputs(8, 2, 16, 64, 32, torch.float32, cuda, 2)
    want = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    with build._lock:           # a fresh load: the set-up runs again
        build._loaded.pop("flash_attention", None)
        build._bound.discard(("flash_attention", fa._bind))
    start = threading.Barrier(threads)

    def hammer(_):
        start.wait()
        got = [flash_attention(q, k, v, causal=True) for _ in range(rounds)]
        torch.cuda.synchronize()
        return all(torch.equal(g, want) for g in got)

    before = flash_attention.launches
    with ThreadPoolExecutor(threads) as pool:
        same = list(pool.map(hammer, range(threads)))
    assert same == [True] * threads
    assert flash_attention.launches - before == threads * rounds


@pytest.mark.parametrize("phi_dtype", ["float32", "int8"])
def test_document_bits_independent_of_lengths_and_order(cuda, phi_dtype):
    """Documents whose fit lengths differ by 4x run longest first; each
    alone gives the bits it gets in the batch, so the order is invisible."""
    D, L, K = 8, 64, 3000
    wid, est, ev, theta, phi, _ = _inputs(D, L, K, 60, 0, cuda, seed=11)
    est.clamp_(min=1.0)
    for d in range(D):                     # fit lengths 16, 22, ..., 64
        est[d, 16 + 48 * d // (D - 1):] = 0.0
    q, scale = quantize_phi(phi, phi_dtype)
    got = _theta_call(wid, est, ev, theta, q, None, scale)
    for d in range(D):
        alone = theta_sweep(wid[d:d + 1].contiguous(),
                            est[d:d + 1].contiguous(),
                            ev[d:d + 1].contiguous(),
                            theta[d:d + 1].contiguous(), q, None, scale,
                            alpha_m1=0.01, num_sweeps=4)
        for x, y in zip(alone, got):
            assert torch.equal(x[0], y[d])


@pytest.mark.parametrize("A", [1, 16, 32, 1025])
@pytest.mark.parametrize("phi_dtype", ["float32", "bfloat16"])
def test_scheduled_paths_match_plain(cuda, A, phi_dtype):
    """The scheduled fit: a warp per token for A <= 1,024 (A = 1, a half
    and a full warp), the wide path's block per token above."""
    K = 10_000 if A <= 32 else 2000
    wid, est, ev, theta, phi, wt = _inputs(5, 70, K, 25, A, cuda, seed=A)
    q, scale = quantize_phi(phi, phi_dtype)
    path = sweep_path(K, A, 70, q.element_size(), q.data_ptr())
    assert path.kind == ("registers" if A <= 1024 else "shared")
    _theta_call(wid, est, ev, theta, q, wt, scale)


@pytest.mark.parametrize("K,kind", [(15_000, "shared"), (50_000, "scratch")])
def test_wide_paths_match_plain(cuda, K, kind):
    """Above the register paths' 10,240 lanes the state goes to shared
    memory, and when 3·K floats do not fit there, to a global scratch."""
    wid, est, ev, theta, phi, _ = _inputs(4, 9, K, 20, 0, cuda, seed=K)
    assert sweep_path(K, 0, 9, 4, phi.data_ptr()).kind == kind
    _theta_call(wid, est, ev, theta, phi, None, None, sweeps=3)


# ---------------------------------------------------------------------------
# Training sweeps
# ---------------------------------------------------------------------------

def _sweep_inputs(D, L, K, W, A, dev, seed=0, consistent=False):
    """A minibatch with duplicate words in every column (W small), zero
    counts, a trailing padded column, and residual-ranked active sets.

    φ̂ is a gamma draw independent of the counts, so a sweep's exclusion
    step (φ̂_w − cnt·μ) can go below 0 — the kernels' arithmetic does not
    care, the sanitizer does.  ``consistent=True`` makes φ̂ hold the
    minibatch's own mass (the draw plus cnt·μ scattered by word, φ̂(k) its
    column sums), as every φ̂ a trainer hands a sweep does; the other
    draws are the same."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 3).astype(np.float32)
    if consistent:
        np.add.at(phi, wid.ravel(), (mu * cnt[..., None]).reshape(-1, K))
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


# ---------------------------------------------------------------------------
# The two-phase sharded sweep's kernels
# ---------------------------------------------------------------------------

def _sharded_inputs(D, L, K, W, A, dev, seed=0):
    """``_sweep_inputs`` plus the cross-shard columns: peers' numerator
    sums (remainder) and, scheduled, a global prev mass above the local."""
    args = _sweep_inputs(D, L, K, W, A, dev, seed=seed)
    rng = np.random.default_rng(seed + 1)
    rem = torch.from_numpy(rng.gamma(1.0, 0.05, (D, L)).astype(np.float32))
    pm = None
    if A:
        pm = sharded_probe_reference(*args[:6], *args[6:], **SWEEP_KW)[1]
        pm = pm + torch.from_numpy(
            rng.random((D, L)).astype(np.float32) * 0.5).to(dev)
    return args, rem.to(dev), pm


def _fold_args(args, rem, pm):
    return (*args[:6], rem, pm, *args[6:])


@pytest.mark.parametrize("D,L,K,W,A", [
    (7, 9, 13, 5, 0),          # odd K/mp, many duplicates per column
    (33, 6, 625, 40, 0),       # stream_1k over 16 ranks: K/mp not /32
    (16, 8, 257, 9, 1),        # A/mp = 1
    (10, 5, 48, 6, 48),        # A/mp = K/mp
    (40, 7, 2500, 30, 4),      # stream_1k over 4 ranks
])
@pytest.mark.parametrize("loglik", [False, True])
def test_sharded_kernels_match_plain(cuda, D, L, K, W, A, loglik):
    args, rem, pm = _sharded_inputs(D, L, K, W, A, cuda, seed=K + A)
    before = sharded_probe.launches
    got = sharded_probe(*args, **SWEEP_KW)
    torch.cuda.synchronize()
    assert sharded_probe.launches == before + 1
    want = sharded_probe_reference(*args, **SWEEP_KW)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=1e-6)
    if A:
        torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=1e-6)
    before = sharded_fold.launches
    fargs = _fold_args(args, rem, pm)
    got = sharded_fold(*fargs, **SWEEP_KW, emit_loglik=loglik)
    torch.cuda.synchronize()
    assert sharded_fold.launches == before + 1
    want = sharded_fold_reference(*fargs, **SWEEP_KW, emit_loglik=loglik)
    _check_sweep(got[:5] + (None,), want[:5] + (None,))
    torch.testing.assert_close(got[5], want[5], rtol=2e-5, atol=1e-6,
                               msg="live mass")
    if loglik:
        torch.testing.assert_close(got[6], want[6], rtol=2e-5, atol=0.0,
                                   msg="loglik u")
    else:
        assert got[6] is None


@pytest.mark.parametrize("A", [0, 4])
def test_hooks_mode_runs_the_plain_loops_on_the_card(cuda, A):
    """``ops.sweep`` under a one-rank hooks plan (``two_phase=False``) runs
    the plain column loop on CUDA tensors — no sweep, probe or fold kernel
    — and gives the CPU's hooks sweep within the sweep tolerances; its
    loglik within rtol 1e-5."""
    from repro_torch.core.types import SweepPlan
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import MeshAxis

    plan = SweepPlan(axis_name=MeshAxis("model", 1, 0), two_phase=False)
    args = _sweep_inputs(24, 7, 777, 9, A, cuda, seed=11)
    sk = dict(word_topics=args[6], token_active=args[7]) if A else {}
    kernels = (gs_sweep, scheduled_sweep, sharded_probe, sharded_fold)
    before = [k.launches for k in kernels]
    got = ops.sweep(*args[:6], **SWEEP_KW, **sk, plan=plan,
                    compute_loglik=True, device=cuda)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    want = ops.sweep(*(a.cpu() for a in args[:6]), **SWEEP_KW,
                     **{k: v.cpu() for k, v in sk.items()}, plan=plan,
                     compute_loglik=True, device="cpu")
    _check_sweep(tuple(x.cpu() for x in (got.mu, got.residual, got.theta,
                                         got.phi_wk, got.phi_k)) + (None,),
                 (want.mu, want.residual, want.theta, want.phi_wk,
                  want.phi_k, None))
    torch.testing.assert_close(got.loglik.cpu(), want.loglik, rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("A", [0, 4])
def test_sharded_kernels_bitwise_repeatable(cuda, A):
    args, rem, pm = _sharded_inputs(64, 12, 777, 8, A, cuda, seed=3)
    for fn, a in ((sharded_probe, args),
                  (sharded_fold, _fold_args(args, rem, pm))):
        kw = dict(SWEEP_KW, emit_loglik=True) if fn is sharded_fold \
            else SWEEP_KW
        x, y = fn(*a, **kw), fn(*a, **kw)
        for p, q in zip(x, y):
            assert (p is None and q is None) or torch.equal(p, q)


@pytest.mark.parametrize("A", [0, 3])
def test_sharded_fold_zero_remainder_is_the_sweep_kernel(cuda, A):
    """remainder 0 and the local prev mass: the fold kernel gives what the
    unsharded sweep kernel gives, within the sweep tolerance."""
    args = _sweep_inputs(24, 9, 301, 7, A, cuda, seed=9)
    zero = torch.zeros_like(args[1])
    pm = sharded_probe(*args, **SWEEP_KW)[1]
    got = sharded_fold(*_fold_args(args, zero, pm), **SWEEP_KW)
    want = (scheduled_sweep if A else gs_sweep)(*args, **SWEEP_KW)
    _check_sweep(got[:5] + (None,), want[:5] + (None,))


@pytest.mark.parametrize("A", [0, 3])
def test_sharded_fold_zero_count_slots_inert(cuda, A):
    args, rem, pm = _sharded_inputs(12, 6, 100, 7, A, cuda, seed=5)
    cnt = args[1]
    cnt[:4] = 0.0
    mu, res, theta, phi, ptot, live, _ = sharded_fold(
        *_fold_args(args, rem, pm), **SWEEP_KW)
    assert float(res[cnt == 0].abs().max()) == 0.0
    torch.testing.assert_close(theta[:4], args[3][:4], rtol=0, atol=0)
    torch.testing.assert_close(phi.sum(0), ptot, rtol=1e-5, atol=1e-3)
    if A:
        act = args[7]
        assert torch.equal(mu[~act], args[2][~act])
        assert float(live[~act].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# φ̂(k)'s float64 total beside the float32 one (the debug_checks φ̂ lockstep
# check reads it): gs_sweep, scheduled_sweep, sharded_fold
# ---------------------------------------------------------------------------

F64 = torch.float64  # lint: host-f64 — φ̂(k)'s float64 total


def _total_case(kind, dev):
    """(kernel call, plain call, φ̂(k), the kernel's terms a sum, moved mass
    of a result) for one of the three kernels; each call takes phi_k64."""
    if kind in ("gs_sweep", "scheduled_sweep"):
        A = 16 if kind == "scheduled_sweep" else 0
        args = _sweep_inputs(40, 7, 3000, 30, A, dev, seed=31,
                             consistent=True)
        fn = scheduled_sweep if A else gs_sweep
        ref = scheduled_sweep_reference if A else gs_sweep_reference
        return (lambda t: fn(*args, **SWEEP_KW, phi_k64=t),
                lambda t: ref(*args, **SWEEP_KW, phi_k64=t), args[5], 40,
                lambda out: out[1].sum((0, 1), dtype=F64))
    if kind.startswith("sharded_fold"):
        A = 4 if kind.endswith("scheduled") else 0
        args, rem, pm = _sharded_inputs(40, 7, 2500, 30, A, dev, seed=32)
        fa = _fold_args(args, rem, pm)
        return (lambda t: sharded_fold(*fa, **SWEEP_KW, phi_k64=t),
                lambda t: sharded_fold_reference(*fa, **SWEEP_KW,
                                                 phi_k64=t),
                args[5], 40, lambda out: out[1].sum((0, 1), dtype=F64))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["gs_sweep", "scheduled_sweep",
                                  "sharded_fold", "sharded_fold_scheduled"])
def test_float64_total_on_the_card(cuda, kind):
    """Every float32 output is the same bits with the float64 total and
    without; the total is its seed plus the kernel's own increments (a
    second call seeded with zeros, 1e-12 relative); and it lies within the
    two float32 summation orders' bound of the plain version's total."""
    run, plain, phi_k, n, moved = _total_case(kind, cuda)
    base = run(None)
    seed = phi_k.to(F64)
    total = seed.clone()
    out = run(total)
    torch.cuda.synchronize()
    for x, y in zip(base, out):
        assert (x is None and y is None) or torch.equal(x, y)
    own = torch.zeros_like(seed)
    run(own)
    torch.testing.assert_close(total, seed + own, rtol=1e-12, atol=0.0)
    want = seed.clone()
    plain(want)
    bound = 1e-12 * want.abs() + sum_order_bound(n, moved(out))
    assert bool(((total - want).abs() <= bound).all()), float(
        ((total - want).abs() - bound).max())


@pytest.mark.parametrize("kind", ["gs_sweep", "scheduled_sweep",
                                  "sharded_fold"])
def test_float64_total_must_be_float64(cuda, kind):
    run = _total_case(kind, cuda)[0]
    phi_k = _total_case(kind, cuda)[2]
    with pytest.raises(ValueError, match="phi_k64"):
        run(phi_k.clone())                      # float32, not float64


# ---------------------------------------------------------------------------
# The active-set column loop's edges (scheduled_sweep, sharded_fold)
# ---------------------------------------------------------------------------

# case: (D, L, K, W, A); the dense sharded form takes A = 0
EDGE_CASES = {
    "one_word_column": (64, 5, 301, 9, 4),   # column 0: a segment of D
    "dead_column": (40, 6, 200, 7, 3),       # column 2: no live token
    "all_inactive": (24, 4, 100, 6, 3),      # no active (dense: live) token
    "A=1": (33, 7, 129, 8, 1),
    "A=K": (17, 5, 40, 6, 40),
    "odd_sizes": (13, 7, 37, 5, 5),          # D·L·K % 4 = 3: the pass's tail
    "unaligned_mu": (16, 6, 64, 7, 4),       # μ 4 bytes past 16: scalar pass
    "D_over_grid": (4500, 3, 24, 50, 2),     # more documents than warps/CTAs
}


def _edge_call(case, form, dev):
    """(kernel, plain version, arguments) of one edge case: the inputs of
    ``_sweep_inputs`` with the case's change, θ̂, φ̂ and φ̂(k) then made to
    hold the minibatch's own assignment (as a trainer's do: no statistic
    goes below zero, however many documents fold into one row), and the
    cross-shard columns of ``_sharded_inputs``."""
    D, L, K, W, A = EDGE_CASES[case]
    A = 0 if form in ("sharded_dense", "gs_sweep") else A
    args = _sweep_inputs(D, L, K, W, A, dev, seed=D + K)
    wid, cnt, mu = args[0], args[1], args[2]
    if case == "one_word_column":
        wid[:, 0] = 0
        cnt[:, 0] = 2.0
        if A:
            args[7][:, 0] = True
    elif case == "dead_column":
        cnt[:, 2] = 0.0
    elif case == "all_inactive":
        if A:
            args[7][:] = False
        else:
            cnt[:] = 0.0
    args[3] = em.fold_theta(mu, cnt)
    args[4] = args[4] + em.fold_phi(mu, cnt, wid, W)[0]
    args[5] = args[4].sum(0)
    if case == "unaligned_mu":
        buf = torch.empty(mu.numel() + 1, device=dev)
        buf[1:] = mu.reshape(-1)
        args[2] = buf[1:].view(mu.shape)
        assert args[2].data_ptr() % 16 == 4 and args[2].is_contiguous()
    if form == "scheduled_sweep":
        return scheduled_sweep, scheduled_sweep_reference, tuple(args)
    if form == "gs_sweep":
        return gs_sweep, gs_sweep_reference, tuple(args)
    rng = np.random.default_rng(D + K + 1)
    rem = torch.from_numpy(rng.gamma(1.0, 0.05, (D, L)).astype(np.float32))
    pm = None
    if A:
        pm = sharded_probe_reference(*args, **SWEEP_KW)[1] + torch.from_numpy(
            rng.random((D, L)).astype(np.float32) * 0.5).to(dev)
    return sharded_fold, sharded_fold_reference, _fold_args(args, rem.to(dev),
                                                            pm)


@pytest.mark.parametrize("form", ["scheduled_sweep", "sharded_scheduled",
                                  "sharded_dense", "gs_sweep"])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_active_loop_edges_match_plain_bitwise(cuda, case, form):
    """Each redesigned form at the column loop's edges: within the sweep
    tolerance of its plain version, the same bits from two launches, one
    persistent column loop a call (4 CUDA operations with the streaming
    pass, 2 for the dense loops, +1 with the stop rule), zero-count slots
    without residual and inactive entries at μ_old.  ``gs_sweep`` runs the
    dense column loop at A = 0: a one-word column, a dead column, no live
    token, more document groups than the card holds CTAs, scalar lanes."""
    fn, ref, a = _edge_call(case, form, cuda)
    dense = form in ("sharded_dense", "gs_sweep")
    for loglik in (False, True):
        kw = dict(SWEEP_KW, emit_loglik=loglik)
        got = fn(*a, **kw)
        torch.cuda.synchronize()
        assert fn.launches_per_call == (2 if dense else 4) + loglik
        again = fn(*a, **kw)
        for x, y in zip(got, again):
            assert (x is None and y is None) or torch.equal(x, y)
        want = ref(*a, **kw)
        if fn in (scheduled_sweep, gs_sweep):
            _check_sweep(got, want)
        else:
            _check_sweep(got[:5] + (None,), want[:5] + (None,))
            torch.testing.assert_close(got[5], want[5], rtol=2e-5,
                                       atol=1e-6, msg="live mass")
            if loglik:
                torch.testing.assert_close(got[6], want[6], rtol=2e-5,
                                           atol=0.0, msg="loglik u")
    cnt = a[1]
    assert float(got[1][cnt == 0].abs().max()) == 0.0
    if not dense:
        act = a[-1]
        assert torch.equal(got[0][~act], a[2][~act])
        assert bool((got[1][~act] == 0).all())
    if case == "all_inactive":       # nothing folds
        assert torch.equal(got[2], a[3]) and torch.equal(got[3], a[4])
        assert torch.equal(got[4], a[5])


@pytest.mark.parametrize("case", ["one_word_column", "D_over_grid"])
@pytest.mark.parametrize("A", [0, 2])
def test_sharded_fold_zero_remainder_edges(cuda, case, A):
    """remainder 0 at the loop's edges: the fold is gs_sweep (dense) or
    scheduled_sweep, within the sweep tolerance."""
    D, L, K, W, _ = EDGE_CASES[case]
    args = _sweep_inputs(D, L, K, W, A, cuda, seed=D)
    if case == "one_word_column":
        args[0][:, 0] = 0
        args[1][:, 0] = 2.0
    zero = torch.zeros_like(args[1])
    pm = sharded_probe(*args, **SWEEP_KW)[1]
    got = sharded_fold(*_fold_args(args, zero, pm), **SWEEP_KW)
    want = (scheduled_sweep if A else gs_sweep)(*args, **SWEEP_KW)
    _check_sweep(got[:5] + (None,), want[:5] + (None,))


# ---------------------------------------------------------------------------
# The dense column loop's paths (gs_sweep), the stop-rule phase and the probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,off,kind,code", [
    (10_000, 0, "registers", 0),
    (10_000, 1, "registers", 1),      # unaligned μ: scalar lanes
    (10_001, 0, "registers", 1),      # K % 4 != 0: scalar lanes
    (REG_MAX_K, 0, "registers", 0),   # the register bound
    (REG_MAX_K + 1, 0, "two-pass", 3),
    (12_000, 0, "two-pass", 2),
    (50_000, 0, "two-pass", 2),       # bigmodel
])
def test_gs_sweep_paths_match_plain(cuda, K, off, kind, code):
    """Each path of the dense column loop against the plain version and
    bitwise twice; the scalar lanes give the 16-byte lanes' bits."""
    args = _sweep_inputs(6, 4, K, 5, 0, cuda, seed=K + off)
    if off:
        args[2] = _offset(args[2], off)
    assert dense_path(K, [args[2]]) == (kind, code)
    got = gs_sweep(*args, **SWEEP_KW, emit_loglik=True)
    torch.cuda.synchronize()
    _check_sweep(got, gs_sweep_reference(*args, **SWEEP_KW,
                                         emit_loglik=True))
    again = gs_sweep(*args, **SWEEP_KW, emit_loglik=True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if off:
        args[2] = args[2].contiguous().clone()
        aligned = gs_sweep(*args, **SWEEP_KW, emit_loglik=True)
        assert all(torch.equal(x, y) for x, y in zip(got, aligned))


@pytest.mark.parametrize("K", [300, 10_000])
def test_gs_sweep_padding_documents_invisible(cuda, K):
    """Zero-count documents appended to a batch (a bucketed minibatch's
    padding) leave the real documents' μ, residual, θ̂, stop-rule partials
    and φ̂, φ̂(k) bit for bit as they were."""
    D = 5 * GROUP_DOCS + 1
    args = _sweep_inputs(D, 6, K, 7, 0, cuda, seed=K)
    pad = 2 * GROUP_DOCS + 1
    padded = [torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                        dtype=x.dtype, device=cuda)])
              for x in args[:4]] + args[4:]
    base = gs_sweep(*args, **SWEEP_KW)
    more = gs_sweep(*padded, **SWEEP_KW)
    for x, y in zip(base[:3], more[:3]):
        assert torch.equal(x, y[:D])
    assert torch.equal(base[3], more[3]) and torch.equal(base[4], more[4])
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=SWEEP_KW["wb"])
    a = sweep_loglik_partials(args[0], args[1], base[2], base[3], base[4],
                              **kw)
    b = sweep_loglik_partials(padded[0], padded[1], more[2], more[3],
                              more[4], **kw)
    assert torch.equal(a, b[:D])


@pytest.mark.parametrize("K", [777, 10_000, 10_001, 60_000])
def test_stop_rule_phase_matches_plain(cuda, K):
    """The stop-rule kernel against the plain per-token partials: 16-byte
    and scalar lanes, w(k) in shared memory, and per token past its
    capacity (K = 60,000); its sum is sweep_loglik within SWEEP_TOL's
    loglik rtol; two launches give the same bits."""
    args = _sweep_inputs(9, 7, K, 6, 0, cuda, seed=K)
    wid, cnt, _, theta, phi, ptot = args
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=SWEEP_KW["wb"])
    before = sweep_loglik_partials.launches
    got = sweep_loglik_partials(wid, cnt, theta, phi, ptot, **kw)
    torch.cuda.synchronize()
    assert sweep_loglik_partials.launches == before + 1
    want = token_loglik(wid, cnt, theta, phi, ptot, kw["wb"],
                        alpha_m1=0.01, beta_m1=0.01)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert float(got[cnt == 0].abs().max()) == 0.0
    torch.testing.assert_close(
        got.sum(), sweep_loglik(wid, cnt, theta, phi, ptot, kw["wb"],
                                alpha_m1=0.01, beta_m1=0.01),
        rtol=1e-5, atol=0.0)
    assert torch.equal(got, sweep_loglik_partials(wid, cnt, theta, phi, ptot,
                                                  **kw))


@pytest.mark.parametrize("A", [0, 3, 16])
def test_sweep_stop_rule_matches_sweep_loglik(cuda, A):
    """gs_sweep's and scheduled_sweep's in-sweep loglik is sweep_loglik on
    their own final statistics (the stop rule)."""
    args = _sweep_inputs(30, 7, 1000, 9, A, cuda, seed=40 + A)
    fn = scheduled_sweep if A else gs_sweep
    out = fn(*args, **SWEEP_KW, emit_loglik=True)
    want = sweep_loglik(args[0], args[1], out[2], out[3], out[4],
                        SWEEP_KW["wb"], alpha_m1=0.01, beta_m1=0.01)
    torch.testing.assert_close(out[5], want, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("K,A,off,kind,code", [
    (2500, 0, 0, "float4", 0),     # stream_1k over 4 ranks
    (625, 0, 0, "scalar", 1),      # K/mp odd: scalar lanes
    (2500, 0, 1, "scalar", 1),     # an unaligned μ base
    (100, 1, 0, "packed", 1),      # A/mp = 1: 32 tokens a warp
    (100, 4, 0, "packed", 4),      # stream_1k's A/mp
    (100, 8, 0, "packed", 8),
    (100, 33, 0, "packed", 32),    # past a warp: 32 lanes a token
])
def test_sharded_probe_paths_match_plain(cuda, K, A, off, kind, code):
    """Each probe path against its plain version, bitwise twice."""
    args = _sweep_inputs(21, 9, K, 11, A, cuda, seed=K + A + off)
    if off:
        args[2] = _offset(args[2], off)
    assert probe_path(K, A, args[2:6]) == (kind, code)
    got = sharded_probe(*args, **SWEEP_KW)
    torch.cuda.synchronize()
    want = sharded_probe_reference(*args, **SWEEP_KW)
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=1e-6)
    if A:
        torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=1e-6)
    again = sharded_probe(*args, **SWEEP_KW)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


# ---------------------------------------------------------------------------
# The E-step kernels of the coarse-block / scan sweeps, BEM and SEM
# ---------------------------------------------------------------------------

ESTEP_KW = dict(alpha_m1=0.01, beta_m1=0.01, wb=141_043 * 0.01)


def _estep_inputs(T, K, G, dev, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.gamma(1.0, 3.0, (T // G, K)).astype(np.float32)
    ph = rng.gamma(0.5, 2.0, (T, K)).astype(np.float32)
    pt = (ph.sum(0) * 40).astype(np.float32)
    mu = rng.dirichlet(np.ones(K), T).astype(np.float32)
    cnt = rng.integers(0, 5, T).astype(np.float32)
    ex = cnt[:, None] * mu
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return t(th), t(ph), t(pt), t(ex), t(mu), t(cnt)


def _check_estep(got, want):
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-7,
                               msg="mu")
    if want[1] is not None:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6,
                                   msg="residual")


@pytest.mark.parametrize("T,K,G", [(37, 10_001, 1), (64, 10_001, 16),
                                   (301, 257, 7), (5, 31, 5)])
@pytest.mark.parametrize("exclude,residual", [(True, True), (False, True),
                                              (True, False)])
def test_fused_estep_matches_plain(cuda, T, K, G, exclude, residual):
    th, ph, pt, ex, mu, cnt = _estep_inputs(T, K, G, cuda, seed=T + K)
    args = (th, ph, pt, ex if exclude else None, mu if residual else None,
            cnt if residual else None)
    before = fused_estep.launches
    got = fused_estep(*args, **ESTEP_KW)
    torch.cuda.synchronize()
    assert fused_estep.launches == before + 1
    want = fused_estep_reference(*args, **ESTEP_KW)
    _check_estep(got, want)
    assert (got[1] is None) == (not residual)
    again = fused_estep(*args, **ESTEP_KW)
    assert all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None)


def test_fused_estep_rows_independent_of_T(cuda):
    th, ph, pt, ex, mu, cnt = _estep_inputs(96, 3001, 8, cuda, seed=2)
    full = fused_estep(th, ph, pt, ex, mu, cnt, **ESTEP_KW)
    part = fused_estep(th[:5].contiguous(), ph[:40].contiguous(), pt,
                       ex[:40].contiguous(), mu[:40].contiguous(),
                       cnt[:40].contiguous(), **ESTEP_KW)
    for a, b in zip(part, full):
        assert torch.equal(a, b[:40])
    # (T, K) rows at an odd T
    expanded = th.repeat_interleave(8, 0)
    for a, b in zip(fused_estep(expanded[:37].contiguous(),
                                ph[:37].contiguous(), pt,
                                ex[:37].contiguous(), mu[:37].contiguous(),
                                cnt[:37].contiguous(), **ESTEP_KW), full):
        assert torch.equal(a, b[:37])


def _offset(x, off):
    """x's values in a contiguous tensor whose base is ``off`` elements past
    an allocation's (a 16-byte-unaligned base when off = 1)."""
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    buf[off:].copy_(x.reshape(-1))
    return buf[off:].view(x.shape)


@pytest.mark.parametrize("K,off,kind,code", [
    (10_000, 0, "registers", 0),
    (10_000, 1, "registers", 1),      # unaligned bases: scalar lanes
    (10_001, 0, "registers", 1),      # K % 4 != 0: scalar lanes
    (10_240, 0, "registers", 0),      # the register bound
    (10_241, 0, "two-pass", 2),
    (50_000, 0, "two-pass", 2),       # bigmodel
])
@pytest.mark.parametrize("exclude,residual", [(True, True), (False, False)])
def test_fused_estep_paths_match_plain(cuda, K, off, kind, code, exclude,
                                       residual):
    T, G = 24, 8
    inputs = _estep_inputs(T, K, G, cuda, seed=K + off)
    th, ph, pt, ex, mu, cnt = [_offset(x, off) for x in inputs]
    args = (th, ph, pt, ex if exclude else None, mu if residual else None,
            cnt if residual else None)
    assert estep_path(K, args[:5]) == (kind, code)
    got = fused_estep(*args, **ESTEP_KW)
    torch.cuda.synchronize()
    _check_estep(got, fused_estep_reference(*args, **ESTEP_KW))
    again = fused_estep(*args, **ESTEP_KW)
    assert all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None)
    if kind == "registers" and off:
        # the scalar lanes give the 16-byte lanes' bits
        aligned = fused_estep(*[None if x is None else x.contiguous().clone()
                                for x in args], **ESTEP_KW)
        assert all(torch.equal(a, b) for a, b in zip(got, aligned)
                   if a is not None)


@pytest.mark.parametrize("G", [1, 16, 128])
def test_fused_estep_group_rows_independent_of_T(cuda, G):
    """θ̂ shared by G tokens (the (T, K) rows, the blocked sweep's block,
    SEM's document) at a ragged T: a row's bits do not depend on T."""
    T = G * (3 if G > 1 else 301)
    th, ph, pt, ex, mu, cnt = _estep_inputs(T, 10_000, G, cuda, seed=G)
    for args in ((th, ph, pt, ex, mu, cnt), (th, ph, pt, None, None, None)):
        full = fused_estep(*args, **ESTEP_KW)
        torch.cuda.synchronize()
        _check_estep(full, fused_estep_reference(*args, **ESTEP_KW))
        t = T - G if G > 1 else 37
        part = fused_estep(th[:t // G].contiguous(), ph[:t].contiguous(), pt,
                           *[None if x is None else x[:t].contiguous()
                             for x in args[3:]], **ESTEP_KW)
        for a, b in zip(part, full):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b[:t])


def _topk_inputs(T, A, dev, seed=0):
    rng = np.random.default_rng(seed)
    th = (rng.gamma(1.0, 3.0, (T, A))).astype(np.float32)
    ph = (rng.gamma(0.5, 20.0, (T, A))).astype(np.float32)
    pt = (rng.gamma(5.0, 1e4, (T, A)) + 1e3).astype(np.float32)
    mu = (rng.dirichlet(np.ones(A), T) * 0.7).astype(np.float32)
    lanes = rng.random((T, A)) < 0.15                       # pad lanes
    mu[lanes] = 0.0
    th[lanes] = 0.0
    cnt = rng.integers(0, 4, T).astype(np.float32)
    act = (rng.random(T) > 0.3) & (cnt > 0)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return [t(th), t(ph), t(pt), t(mu), t(cnt), t(act)]


@pytest.mark.parametrize("T,A", [(1000, 1), (16_384, 16), (333, 32),
                                 (77, 40)])
def test_topk_estep_matches_plain(cuda, T, A):
    args = _topk_inputs(T, A, cuda, seed=T + A)
    before = topk_estep.launches
    got = topk_estep(*args, **ESTEP_KW)
    torch.cuda.synchronize()
    assert topk_estep.launches == before + 1
    want = topk_estep_reference(*args, **ESTEP_KW)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    act = args[5]
    assert torch.equal(got[0][~act], args[3][~act])
    assert float(got[1][~act].abs().max()) == 0.0
    again = topk_estep(*args, **ESTEP_KW)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    part = topk_estep(*[x[:T // 3].contiguous() for x in args], **ESTEP_KW)
    assert torch.equal(part[0], got[0][:T // 3])


def _loop_inputs(D, L, K, W, A, dev, seed=0):
    """A blocked sweep's operands: duplicate words across documents and
    columns, zero counts (a padded last column, an active token of count
    0), 25% inactive tokens, and pad lanes — topic 0, active for every
    word, carries no μ and no θ̂ in the first two documents."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    mu[:2, :, 0] = 0.0
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 3).astype(np.float32)
    phi += np.einsum("dlk,dl,dlw->wk", mu, cnt,
                     np.eye(W, dtype=np.float32)[wid])   # the batch's own
    wt = np.stack([np.concatenate([[0], 1 + rng.choice(K - 1, A - 1,
                                                       replace=False)])
                   for _ in range(W)]).astype(np.int32)
    act = (rng.random((D, L)) > 0.25) & (cnt > 0)
    act[2, 0], cnt[2, 0] = True, 0.0
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return [t(wid), t(cnt), t(wt), t(act), t(mu), t(theta), t(phi),
            t(phi.sum(0))]


# (D, L, K, W, A, B)
LOOP_CASES = {
    "stream_1k_A_B=3": (40, 12, 3000, 30, 16, 3),
    "stream_1k_A_B=L": (40, 12, 3000, 30, 16, 12),
    "A>32_ragged": (33, 10, 1001, 9, 40, 4),     # nb 3, last block 1 column
    "A=1_B=1": (16, 8, 257, 9, 1, 1),
    "A=K": (10, 5, 48, 6, 48, 2),
    "one_word": (64, 6, 301, 1, 4, 2),            # one run of every token
    "shared_topics": (24, 7, 9, 5, 8, 3),         # a document's tokens share
    "many_lone_words": (20, 9, 77, 400, 5, 3),
    "D_over_grid": (4500, 3, 24, 50, 2, 3),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_topk_loop_matches_plain(cuda, case):
    """The block loop against its plain version on the card (the blocked
    scan over the E-step's plain version, sorted ``index_put_`` folds):
    within the sweep tolerance, token topic ids equal; two launches give
    the same bits; one loop launch a sweep (3 CUDA operations: the μ copy,
    the barrier's zeroing, the loop); no input modified; inactive tokens
    keep μ, and they and zero-count slots carry no |Δ|; pad lanes keep no
    mass."""
    D, L, K, W, A, B = LOOP_CASES[case]
    args = _loop_inputs(D, L, K, W, A, cuda, seed=D + K + B)
    before = [x.clone() for x in args]
    n = blocked_sweep.launches
    got = blocked_sweep(*args, num_blocks=B, **SWEEP_KW)
    torch.cuda.synchronize()
    assert blocked_sweep.launches == n + 1
    assert blocked_sweep.launches_per_call == 3
    want = blocked_sweep_reference(*args, num_blocks=B, **SWEEP_KW)
    names = ("theta", "phi_wk", "phi_k", "mu", "abs_delta")
    for name, a, b in zip(names, got[:5], want[:5]):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5 * scale,
                                   msg=name)
    assert torch.equal(got[5], want[5])
    again = blocked_sweep(*args, num_blocks=B, **SWEEP_KW)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    for x, y in zip(args, before):
        assert torch.equal(x, y)
    cnt, act, mu = args[1], args[3], args[4]
    assert torch.equal(got[3][~act], mu[~act])
    assert float(got[4][~act].abs().max()) == 0.0
    assert float(got[4][cnt == 0].abs().max()) == 0.0
    assert float(got[3][:2, :, 0].abs().max()) == 0.0


def test_topk_loop_block_counts(cuda):
    """Every block count of one minibatch, B = 1 … L: the loop against its
    plain version (the ragged last blocks of B = 5, 7, 9, 11)."""
    D, L, K, W, A = 24, 12, 200, 10, 6
    args = _loop_inputs(D, L, K, W, A, cuda, seed=5)
    for B in range(1, L + 1):
        assert block_width(L, B)[0] == -(-L // B)
        got = blocked_sweep(*args, num_blocks=B, **SWEEP_KW)
        want = blocked_sweep_reference(*args, num_blocks=B, **SWEEP_KW)
        for a, b in zip(got[:5], want[:5]):
            scale = max(1.0, float(b.abs().max()))
            torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5 * scale,
                                       msg=f"B={B}")


@pytest.mark.parametrize("blocks,impl,A", [(3, "fused", 0), (0, "scan", 0),
                                           (3, "fused", 4), (0, "scan", 4)])
def test_blocked_sweeps_bitwise_repeatable(cuda, blocks, impl, A):
    """The blocked scans fold duplicate (word, topic) pairs through sorted
    segment sums: the same bits on every run."""
    args = _sweep_inputs(64, 12, 777, 8, A, cuda, seed=3)
    wid, cnt, mu, theta, phi, ptot = args[:6]
    cfg = LDAConfig(num_topics=777, vocab_size=2000, iem_blocks=blocks,
                    sweep_impl=impl, active_topics=max(A, 1))
    batch, local = MinibatchData(wid, cnt), LocalState(mu, theta)
    outs = []
    for _ in range(2):
        if A:
            gen = torch.Generator(device=cuda).manual_seed(1)
            r = torch.rand((8, 777), device=cuda, generator=gen)
            loc, p, pk, sc, _ = foem.scheduled_iem_sweep(
                batch, local, phi, ptot, SchedulerState(r, r.sum(-1)), cfg)
            outs.append((loc.mu, loc.theta_dk, p, pk, sc.r_wk))
        else:
            loc, p, pk = em.iem_sweep(batch, local, phi, ptot, cfg)
            outs.append((loc.mu, loc.theta_dk, p, pk))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sem_step_bitwise_repeatable_and_plain_close(cuda):
    rng = np.random.default_rng(4)
    D, L, K, W = 16, 10, 1001, 30
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 4, (D, L)).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 5).astype(np.float32)
    mu0 = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=6,
                    ppl_check_every=2)
    stats = GlobalStats(phi, phi.sum(0), np.int32(0))
    runs = [sem.sem_step(None, MinibatchData(wid, cnt), stats, cfg, mu0=mu0,
                         device=dev) for dev in (cuda, cuda, "cpu")]
    assert runs[0][2].sweeps_run == runs[1][2].sweeps_run
    for a, b in zip(runs[0][0][:2], runs[1][0][:2]):
        assert torch.equal(a, b)
    assert runs[0][2].sweeps_run == runs[2][2].sweeps_run
    torch.testing.assert_close(runs[0][0].phi_wk.cpu(), runs[2][0].phi_wk,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("algorithm,blocks", [("foem", 3), ("sem", 0)])
def test_blocked_and_sem_training_prefetch_bitwise_on_card(cuda, tmp_path,
                                                           algorithm, blocks):
    """The coarse-block FOEM trainer and the SEM trainer on the card:
    prefetch depth 0 and 1 give the same store bits."""
    from repro_torch.core import FOEMTrainer, ParameterStore
    from repro_torch.data import synthetic_lda_corpus
    from repro_torch.sparse import MinibatchStream

    corpus, _ = synthetic_lda_corpus(120, 150, 5, mean_doc_len=30, seed=11)
    out = []
    before = (fused_estep.launches, blocked_sweep.launches)
    for depth in (0, 1):
        cfg = LDAConfig(num_topics=5, vocab_size=150, max_sweeps=6,
                        active_topics=2, ppl_check_every=2,
                        iem_blocks=blocks)
        store = ParameterStore(str(tmp_path / f"d{depth}"), num_topics=5,
                               vocab_capacity=150, buffer_rows=64)
        tr = FOEMTrainer(cfg, store, seed=0, prefetch_depth=depth,
                         algorithm=algorithm, device=cuda)
        ms = tr.fit_stream(iter(MinibatchStream(corpus, 40, seed=0,
                                                epochs=None)), max_steps=4)
        assert len(ms) == 4
        out.append((store.dense_phi().copy(), store.phi_k.copy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert fused_estep.launches > before[0]
    if algorithm == "foem":
        assert blocked_sweep.launches > before[1]


@pytest.mark.parametrize("blocks,impl,A", [(3, "fused", 0), (0, "scan", 0),
                                           (3, "fused", 4), (0, "scan", 4)])
def test_blocked_sweeps_match_the_cpu(cuda, blocks, impl, A):
    """The blocked scans on the card (kernels, sorted CUDA folds) against
    the same scans on the CPU (plain versions, serial folds)."""
    args = _sweep_inputs(48, 12, 333, 9, 0, cuda, seed=8)
    wid, cnt, mu, theta, phi, ptot = args
    cfg = LDAConfig(num_topics=333, vocab_size=2000, iem_blocks=blocks,
                    sweep_impl=impl, active_topics=max(A, 1))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        batch = MinibatchData(wid.to(dev), cnt.to(dev))
        local = LocalState(mu.to(dev), theta.to(dev))
        if A:
            r = torch.from_numpy(np.random.default_rng(2).gamma(
                1.0, 1.0, (9, 333)).astype(np.float32)).to(dev)
            loc, p, pk, sc, _ = foem.scheduled_iem_sweep(
                batch, local, phi.to(dev), ptot.to(dev),
                SchedulerState(r, r.sum(-1)), cfg)
            outs.append([x.cpu() for x in (loc.mu, loc.theta_dk, p, pk,
                                           sc.r_wk)])
        else:
            loc, p, pk = em.iem_sweep(batch, local, phi.to(dev),
                                      ptot.to(dev), cfg)
            outs.append([x.cpu() for x in (loc.mu, loc.theta_dk, p, pk)])
    for a, b in zip(*outs):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("blocks,impl,A", [(4, "fused", 3), (0, "scan", 3),
                                           (4, "fused", 0)])
def test_blocked_foem_minibatch_matches_the_cpu(cuda, blocks, impl, A):
    """A coarse-block / scan inner loop on the card runs the CPU's number of
    sweeps to the same statistics (K = 8, A = 3: no near-ties in the
    top-A selection)."""
    rng = np.random.default_rng(5)
    D, L, K, W = 32, 12, 8, 60
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 5, (D, L)).astype(np.float32)
    cnt[:, -2:] = 0.0
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 4).astype(np.float32)
    mu0 = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=9,
                    ppl_check_every=3, active_topics=A, iem_blocks=blocks,
                    sweep_impl=impl)
    got, want = (foem.foem_minibatch(None, MinibatchData(wid, cnt), phi,
                                     phi.sum(0), cfg, mu0=mu0, device=dev)
                 for dev in (cuda, "cpu"))
    assert got.diag.sweeps_run == want.diag.sweeps_run
    torch.testing.assert_close(got.phi_wk.cpu(), want.phi_wk, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got.diag.final_train_ppl.cpu(),
                               want.diag.final_train_ppl, rtol=1e-4, atol=0)


# (rtol, atol) of the attention kernel against its plain version: float32
# scores and sums in another order; in bfloat16 the output is rounded to
# 8 bits (an ulp is 7.8e-3 at 1) and p is rounded at another running max
ATTN_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (8e-3, 1.6e-2)}


def _attn_inputs(BH, BHkv, Sq, Sk, d, dtype, dev, seed, off=0):
    """q, k, v; with ``off`` each a contiguous view ``off`` elements into
    its storage (an unaligned base: the kernel's plain-load staging)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((n * s * d + off,), generator=g, device=dev)
            .to(dtype)[off:].view(n, s, d)
            for n, s in ((BH, Sq), (BHkv, Sk), (BHkv, Sk))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("BH,BHkv,Sq,Sk,d,causal,window,qoff,off", [
    (4, 2, 64, 64, 32, True, 0, 0, 0),
    (8, 2, 70, 70, 120, True, 24, 0, 0),     # ragged, window, d = 120
    (8, 8, 1, 300, 128, True, 0, 250, 0),    # decode in a deeper cache
    (32, 8, 1, 4096, 120, True, 4096, 4095, 0),  # danube's ring decode
    (6, 1, 45, 77, 128, True, 0, 32, 0),     # MQA, ragged Sq and Sk
    (4, 2, 33, 97, 64, False, 0, 0, 0),      # non-causal
    (2, 1, 20, 20, 17, True, 0, 0, 0),       # an odd head dim
    (4, 2, 16, 40, 32, True, 4, 60, 0),      # every row fully masked
    (4, 2, 64, 200, 64, False, 0, 0, 0),     # Sk ragged against BK = 64
    (16, 4, 4, 100, 128, True, 0, 50, 0),    # Sq·G = 16: the decode form
    (4, 4, 17, 100, 128, True, 0, 20, 0),    # Sq·G = 17: the prefill form
    (64, 8, 1, 8192, 128, True, 0, 4095, 0),  # decode, an 8,192-slot cache
    (64, 8, 1, 8192, 128, True, 0, 6000, 0),
    (64, 8, 1, 8192, 128, True, 0, 8191, 0),
    (4, 1, 1, 1000, 128, True, 0, 999, 0),   # B·Hkv = 1 decode
    (8, 2, 70, 70, 120, True, 24, 0, 1),     # unaligned base, d = 120
    (4, 2, 33, 50, 17, True, 0, 0, 17),      # offset by a row of odd d
    # llama-3.2-vision's cross-attention: non-causal, Sq > Sk, the 1,601
    # image tokens ragged against every key tile; its decode form
    (8, 2, 2048, 1601, 128, False, 0, 0, 0),
    (32, 8, 1, 1601, 128, False, 0, 0, 0),
    # musicgen: MHA (G = 1), d = 64, causal prefill and decode
    (24, 24, 300, 300, 64, True, 0, 0, 0),
    (24, 24, 1, 300, 64, True, 0, 299, 0),
])
def test_flash_attention_matches_plain(cuda, dtype, BH, BHkv, Sq, Sk, d,
                                       causal, window, qoff, off):
    q, k, v = _attn_inputs(BH, BHkv, Sq, Sk, d, dtype, cuda, Sq + Sk + d,
                           off)
    assert q.is_contiguous() and q.storage_offset() == off
    kw = dict(causal=causal, window=window, q_offset=qoff)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, **kw)
    assert got.dtype == dtype and torch.isfinite(got).all()
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert torch.equal(flash_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_row_bits_independent_of_sq(cuda, dtype):
    """A decode call (Sq = 1, the 16-row tile) gives the bits of the same
    row in a prefill call (64-row tiles, a wider band of key tiles)."""
    q, k, v = _attn_inputs(32, 8, 200, 200, 128, dtype, cuda, 1)
    full = flash_attention(q, k, v, causal=True, window=150)
    for i in (0, 63, 64, 130, 199):
        one = flash_attention(q[:, i:i + 1].contiguous(), k, v, causal=True,
                              window=150, q_offset=i)
        assert torch.equal(one, full[:, i:i + 1])


# (rtol, atol) of the reduced LM on the card against the CPU: float32 sums
# in another order through four layers; in bf16 both sides round every
# layer output to 8 bits, at other places (cuBLAS against the CPU's matrix
# products, the kernel against the plain version): two ulps at [2, 4), as
# the bf16 LM against the JAX package (tests/test_torch_lm.py)
LM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 0.0625)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["granite-8b", "h2o-danube-3-4b"])
def test_reduced_lm_prefill_and_decode_match_the_cpu(cuda, name, dtype):
    """The reduced LM on the card through the kernel, against the same
    weights on the CPU through the plain version."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build
    from repro_torch.models.lm import tree_map

    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype=dtype)
    m_cpu, m_gpu = build(cfg, device="cpu"), build(cfg, device=cuda)
    p_cpu = m_cpu.init_params(torch.Generator().manual_seed(0))
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    # danube's ring (32 slots) wraps during the decode steps
    B, S, T = 2, 24, 40
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, T)))
    out = []
    for m, p in ((m_gpu, p_gpu), (m_cpu, p_cpu)):
        before = flash_attention.launches
        logits, pre = m.prefill(p, {"tokens": tok[:, :S]})
        cache = m.init_cache(B, T)
        for j in cache:
            for n in ("k", "v"):
                cache[j][n][:, :, :, :S] = pre[j][n]
        steps = []
        for t in range(S, T):
            lg, cache = m.decode_step(p, cache, {"tokens": tok[:, t:t + 1]},
                                      t)
            steps.append(lg)
        launched = flash_attention.launches - before
        out.append((logits.float().cpu(), torch.cat(steps, 1).float().cpu(),
                    launched))
    (lg_g, dec_g, n_g), (lg_c, dec_c, n_c) = out
    assert n_g == cfg.num_layers * (1 + T - S) and n_c == 0
    rtol, atol = LM_TOL[dtype]
    torch.testing.assert_close(lg_g, lg_c, rtol=rtol, atol=atol)
    torch.testing.assert_close(dec_g, dec_c, rtol=rtol, atol=atol)


def _new_family_batch(cfg, B, S, seed, dev):
    """Seeded inputs of the hybrid, VLM or audio LM: tokens (an audio
    config's frame embeddings) and a VLM's image embeddings."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    if cfg.frontend == "audio_frames":
        out["embeds"] = torch.randn((B, S, cfg.d_model), generator=g)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    if cfg.frontend == "image_patches":
        out["image_embeds"] = torch.randn((B, cfg.image_tokens, cfg.d_model),
                                          generator=g)
    return {k: t.to(dev) for k, t in out.items()}


@pytest.mark.parametrize("name,dtype", [
    ("llama-3.2-vision-11b", "float32"), ("llama-3.2-vision-11b", "bfloat16"),
    ("musicgen-medium", "float32"), ("musicgen-medium", "bfloat16"),
    ("jamba-1.5-large-398b", "float32")])
def test_new_family_lm_prefill_and_decode_match_the_plain_path(cuda, name,
                                                               dtype):
    """The VLM, audio and hybrid LMs at full attention width with their
    depth cut to one super-block (5, 2 and 8 layers), seeded weights, on the
    card: prefill of 2 × 40 positions and 8 decode steps through the kernels
    — one launch a self-attention and a cross-attention layer a call —
    against the same on the card through the plain attention
    (``flash_attention_reference``), within the kernel's tolerance carried
    through the layers (``LM_TOL``).  jamba (d 8,192, 64 heads over 8, 16
    experts top-2) has its FFNs cut to d_ff 2,048 so that float32 fits
    beside the plain path, and runs in float32 only: in bf16 a routing
    near-tie may flip between the two attentions' ulps and move a token by
    O(1)."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.serve import place_prefill
    from repro_torch.models import build

    layers = {"llama-3.2-vision-11b": 5, "musicgen-medium": 2,
              "jamba-1.5-large-398b": 8}[name]
    cfg = dataclasses.replace(ARCHS[name], num_layers=layers, dtype=dtype)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, d_ff=2048)
    n_attn = sum(cfg.is_attn_layer(i) + cfg.is_cross_attn_layer(i)
                 for i in range(cfg.num_layers))
    model = build(cfg, device=cuda)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    B, S, steps = 2, 40, 8
    batch = _new_family_batch(cfg, B, S + steps, 1, cuda)

    def at(b, lo, hi):
        return {k: (t if k == "image_embeds" else t[:, lo:hi])
                for k, t in b.items()}

    def run():
        with torch.no_grad():
            logits, pre = model.prefill(params, at(batch, 0, S))
            cache = model.init_cache(B, S + steps)
            place_prefill(cache, pre)
            outs = [logits]
            for t in range(S, S + steps):
                lg, cache = model.decode_step(params, cache,
                                              at(batch, t, t + 1), t)
                outs.append(lg)
        return torch.cat(outs, 1).float().cpu()

    before = flash_attention.launches
    got = run()
    assert flash_attention.launches - before == n_attn * (1 + steps)
    real = ops.attention
    ops.attention = (lambda q, k, v, *, causal=True, window=0, q_offset=0:
                     flash_attention_reference(q, k, v, causal=causal,
                                               window=window,
                                               q_offset=q_offset))
    try:
        want = run()
    finally:
        ops.attention = real
    assert torch.isfinite(got).all()
    rtol, atol = LM_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("BH,BHkv,Sq,Sk,d,qoff", [
    (8, 2, 70, 70, 120, 0),                  # prefill, d = 120
    (16, 4, 4, 100, 128, 50),                # Sq·G = 16: the decode form
    (64, 8, 1, 4096, 128, 4095),             # a decode step
])
def test_flash_attention_output_bits_same_with_lse(cuda, dtype, BH, BHkv,
                                                   Sq, Sk, d, qoff):
    """Writing the log-sum-exp changes no bit of the output, and the lse is
    the plain version's (float32 sums in another order: atol 1e-5)."""
    q, k, v = _attn_inputs(BH, BHkv, Sq, Sk, d, dtype, cuda, 5)
    kw = dict(causal=True, window=48, q_offset=qoff)
    o = flash_attention(q, k, v, **kw)
    o2, lse = flash_attention(q, k, v, **kw, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    assert lse.shape == (BH, Sq) and lse.dtype == torch.float32
    _, want = flash_attention_reference(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


# The attention backward kernels against torch.autograd of the plain
# version.  float32, elementwise (rtol, atol): sums of up to Sk·G terms in
# another order (~1e-6 relative) carried through exp and three products.
# bfloat16: screened elementwise against the bf16 plain version at one ulp
# relative and one ulp at [8, 16) absolute, and held by (head, 64-row tile)
# block against the float32 truth (the plain version on float32 copies of
# the same values): ||got_t - true_t|| within 2^-7 of ||true_t|| + 2^-4 of
# the rms tile norm — the kernel rounds the gradients to 8 bits once (~2^-9
# of a block) and takes D from the bf16 o, as SDPA does, which moves a row
# that attends to one key by up to ~0.2 of its small norm but a tile little
# (chip_smoke.py's BWD_TILE_TOL, BWD_TILE_FLOOR)
BWD_TOL = {torch.float32: (1e-4, 1e-4),
           torch.bfloat16: (2.0 ** -7, 2.0 ** -4)}
BWD_TILE, BWD_TILE_TOL, BWD_TILE_FLOOR = 64, 2.0 ** -7, 2.0 ** -4


def _bwd_tile_error(got, want):
    err, norm = [], []
    for a, b in zip(got.float().split(BWD_TILE, 1),
                    want.float().split(BWD_TILE, 1)):
        err.append((a - b).flatten(1).norm(dim=1))
        norm.append(b.flatten(1).norm(dim=1))
    err, norm = torch.stack(err, 1), torch.stack(norm, 1)
    floor = BWD_TILE_FLOOR * norm.pow(2).mean().sqrt()
    return float((err / (norm + floor)).max())


def _float32_truth(q, k, v, dout, **kw):
    return flash_attention_backward_reference(
        q.float(), k.float(), v.float(), dout.float(), **kw)


def _assert_backward_close(got, want, truth, dtype):
    for name, a, b, t in zip(("dq", "dk", "dv"), got, want, truth):
        assert a.dtype == dtype and a.shape == b.shape, name
        rtol, atol = BWD_TOL[dtype]
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol, msg=name)
        if dtype == torch.bfloat16:
            assert _bwd_tile_error(a, t) <= BWD_TILE_TOL, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("BH,BHkv,S,d,causal,window", [
    (4, 2, 64, 32, True, 0),
    (8, 2, 70, 120, True, 24),               # GQA, a window, d = 120
    (8, 8, 130, 128, True, 0),               # MHA, ragged 64-row tiles
    (4, 1, 100, 64, False, 0),               # MQA, non-causal
    (6, 2, 257, 120, True, 100),             # ragged tiles, window < S
    (4, 4, 33, 17, True, 0),                 # an odd head dim
    (32, 8, 300, 128, True, 4096),           # granite's grouping, window
                                             # wider than S
    (8, 2, (130, 300), 120, True, 0),        # Sq < Sk, q_offset = Sk - Sq
    (8, 2, 1024, 120, True, 4096),           # danube's grouping, 2 KV heads
    (8, 2, 200, 100, True, 0),               # 200-byte rows: no TMA
    (6, 2, 400, 64, True, 40),               # a window < one 128-key tile
    # llama-3.2-vision's cross-attention: non-causal, Sq > Sk, Sk = 1,601
    # ragged against every tile width
    (8, 2, (2048, 1601), 128, False, 0),
    (4, 1, (300, 77), 128, False, 0),
    # musicgen: MHA (G = 1), d = 64, causal
    (24, 24, 300, 64, True, 0),
])
def test_flash_attention_backward_matches_plain(cuda, dtype, BH, BHkv, S, d,
                                                causal, window):
    """S is Sq = Sk or (Sq, Sk), the queries then the last Sq positions
    (q_offset = Sk - Sq; negative for a non-causal Sq > Sk, where no mask
    reads it)."""
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    q, _, _ = _attn_inputs(BH, BHkv, Sq, Sk, d, dtype, cuda, Sq + d)
    _, k, v = _attn_inputs(BH, BHkv, Sk, Sk, d, dtype, cuda, Sk + d)
    g = torch.Generator(device=cuda).manual_seed(Sq)
    dout = torch.randn((BH, Sq, d), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq)
    o, lse = flash_attention(q, k, v, **kw, return_lse=True)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, o, dout, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    want = flash_attention_backward_reference(q, k, v, dout, **kw)
    _assert_backward_close(got, want, _float32_truth(q, k, v, dout, **kw),
                           dtype)
    again = flash_attention_backward(q, k, v, o, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("BH,BHkv,S,d,window", [
    (8, 2, 256, 120, 0),
    (8, 2, 300, 128, 100),
])
def test_flash_attention_backward_check_sees_planted_faults(cuda, BH, BHkv,
                                                            S, d, window):
    """The bfloat16 tile check fails on a 64-key tile of dk zeroed in the
    middle of the sequence and on the lse of 64 query rows there shifted
    by 2^-5 (their p scaled by 0.97), and passes the kernel's own
    gradients."""
    dtype = torch.bfloat16
    q, k, v = _attn_inputs(BH, BHkv, S, S, d, dtype, cuda, 3)
    g = torch.Generator(device=cuda).manual_seed(4)
    dout = torch.randn((BH, S, d), generator=g, device=cuda).to(dtype)
    kw = dict(causal=True, window=window)
    o, lse = flash_attention(q, k, v, **kw, return_lse=True)
    got = flash_attention_backward(q, k, v, o, dout, lse, **kw)
    want = flash_attention_backward_reference(q, k, v, dout, **kw)
    truth = _float32_truth(q, k, v, dout, **kw)
    _assert_backward_close(got, want, truth, dtype)
    mid = slice(S // 2, S // 2 + BWD_TILE)
    dk = got[1].clone()
    dk[0, mid] = 0
    assert _bwd_tile_error(dk, truth[1]) > BWD_TILE_TOL
    shifted = lse.clone()
    shifted[0, mid] += 2.0 ** -5
    bad = flash_attention_backward(q, k, v, o, dout, shifted, **kw)
    assert _bwd_tile_error(bad[0], truth[0]) > BWD_TILE_TOL


def test_attention_under_grad_gives_weight_gradients(cuda):
    """attention_apply under autograd on the card: ops.attention goes
    through FlashAttentionFunction (one forward and one backward kernel
    call), and x, wq, wk, wv, wo get the CPU's gradients."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(0)
    B, S, D, H, KV, hd = 2, 150, 64, 8, 2, 16
    p_cpu = layers.attention_init(g, D, H, KV, hd, torch.float32)
    x = torch.randn((B, S, D), generator=g)
    w = torch.randn((B, S, D), generator=g)
    kw = dict(num_heads=H, num_kv=KV, hd=hd, causal=True, window=40,
              rope_theta=1e4)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        p = {n: t.to(dev).requires_grad_() for n, t in p_cpu.items()}
        xd = x.to(dev).requires_grad_()
        fwd, bwd = flash_attention.launches, flash_attention_backward.launches
        o, _ = layers.attention_apply(p, xd, None,
                                      positions=torch.arange(S, device=dev),
                                      **kw)
        (o * w.to(dev)).sum().backward()
        if dev.type == "cuda":
            assert flash_attention.launches == fwd + 1
            assert flash_attention_backward.launches == bwd + 1
        assert all(p[n].grad is not None for n in ("wq", "wk", "wv", "wo"))
        grads.append([t.grad.cpu() for t in (xd, *p.values())])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["granite-8b", "h2o-danube-3-4b"])
def test_reduced_lm_loss_and_gradients_match_the_cpu(cuda, name):
    """The reduced LM's training loss and every gradient leaf on the card
    (the kernels, forward and backward) against the same weights on the
    CPU (the plain attention's autograd), float32, S = 1,024: two CE
    chunks; tolerance as the CPU tests hold them to the JAX package."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build
    from repro_torch.models.lm import tree_map

    cfg = ARCHS[name].reduced()
    m_cpu, m_gpu = build(cfg, device="cpu"), build(cfg, device=cuda)
    p_cpu = m_cpu.init_params(torch.Generator().manual_seed(0))
    p_gpu = tree_map(lambda t: t.to(cuda).requires_grad_(), p_cpu)
    tree_map(lambda t: t.requires_grad_(), p_cpu)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, 1025)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    before = flash_attention_backward.launches
    loss_gpu = m_gpu.loss_fn(p_gpu, batch)
    loss_gpu.backward()
    assert flash_attention_backward.launches == before + cfg.num_layers
    loss_cpu = m_cpu.loss_fn(p_cpu, batch)
    loss_cpu.backward()
    torch.testing.assert_close(loss_gpu.detach().cpu(), loss_cpu.detach(),
                               rtol=1e-4, atol=1e-6)
    tree_map(lambda a, b: torch.testing.assert_close(
        a.grad.cpu(), b.grad, rtol=1e-4, atol=1e-6), p_gpu, p_cpu)


# ---------------------------------------------------------------------------
# The baselines (OVB, SCVB, OGS) and the serving engine
# ---------------------------------------------------------------------------

def _baseline_estep_args(form, T, K, G, dev, seed=0):
    """``fused_estep``'s operands in the OVB form (exp Ψ of θ̂+α, φ̂_w+β,
    φ̂(k)+Wβ; a = b = c = 0) or the SCVB form (raw statistics, a = α,
    b = β, c = Wβ), θ̂ one row per G tokens."""
    th, ph, pt, _, _, _ = _estep_inputs(T, K, G, dev, seed=seed)
    alpha = beta = 1.01
    W = 141_043
    if form == "ovb":
        dg = torch.special.digamma
        return ((dg(th + alpha).exp(), dg(ph + beta).exp(),
                 dg(pt + W * beta).exp(), None, None, None),
                dict(alpha_m1=0.0, beta_m1=0.0, wb=0.0))
    return ((th, ph, pt, None, None, None),
            dict(alpha_m1=alpha, beta_m1=beta, wb=W * beta))


@pytest.mark.parametrize("form", ["ovb", "scvb"])
@pytest.mark.parametrize("T,K,G", [(256, 10_000, 128), (45, 10_001, 15),
                                   (24, 50_000, 8), (96, 300, 32)])
def test_fused_estep_baseline_forms_match_plain(cuda, form, T, K, G):
    """The two input forms no earlier caller launched (a = 0 with c = 0;
    a = α, b = β, c = Wβ) against the plain version, on every path."""
    args, kw = _baseline_estep_args(form, T, K, G, cuda, seed=T + K)
    before = fused_estep.launches
    got = fused_estep(*args, **kw)
    torch.cuda.synchronize()
    assert fused_estep.launches == before + 1
    _check_estep(got, fused_estep_reference(*args, **kw))
    assert torch.equal(got[0], fused_estep(*args, **kw)[0])


@pytest.mark.parametrize("algo", ["ovb", "scvb", "ogs"])
def test_baselines_on_card_match_the_cpu(cuda, algo):
    """Each baseline step on the card against the same step on the CPU
    (μ₀, z₀ and the Gumbel draws injected): OVB and SCVB within the
    cross-package tolerance, one ``fused_estep`` launch a sweep, the same
    bits twice; OGS's sampled topics and θ̂ bit for bit (integer-count
    sums) and no ``fused_estep`` launch."""
    from repro_torch.core.baselines import ALGORITHMS

    rng = np.random.default_rng(6)
    D, L, K, W = 16, 12, 1001, 40
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 4, (D, L)).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 5).astype(np.float32)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=6,
                    rho_mode="stepwise")
    stats = GlobalStats(phi, phi.sum(0), np.int32(2))
    if algo == "ogs":
        kw = dict(z0=rng.integers(0, K, (D, L)),
                  gumbel=[rng.gumbel(size=(D, L, K)).astype(np.float32)
                          for _ in range(8)])
    else:
        kw = dict(mu0=rng.dirichlet(np.ones(K), (D, L)).astype(np.float32))
    before = fused_estep.launches
    runs = [ALGORITHMS[algo](None, MinibatchData(wid, cnt), stats, cfg,
                             device=dev, **kw) for dev in (cuda, cuda, "cpu")]
    launched = fused_estep.launches - before
    assert launched == (0 if algo == "ogs" else 2 * cfg.max_sweeps)
    for a, b in zip(runs[0][0][:2], runs[1][0][:2]):
        assert torch.equal(a, b)
    (gpu, gloc, gdiag), (cpu, cloc, cdiag) = runs[0], runs[2]
    if algo == "ogs":
        assert torch.equal(gloc.mu.cpu(), cloc.mu)
        assert torch.equal(gloc.theta_dk.cpu(), cloc.theta_dk)
    torch.testing.assert_close(gpu.phi_wk.cpu(), cpu.phi_wk, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(gloc.theta_dk.cpu(), cloc.theta_dk,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gdiag.final_train_ppl.cpu(),
                               cdiag.final_train_ppl, rtol=1e-4, atol=0)


def test_engine_slot_invariance_on_card(cuda, tmp_path):
    """Through the engine on the card (rel_tol = 0), a document's θ equals
    bitwise the same document in another packing of the engine's launch
    shape through ``TopicServer.infer`` with its per-document θ̂₀ — beside
    strangers and alone — and every θ row sums to 1."""
    from repro_torch.core import ParameterStore
    from repro_torch.launch.serve import (
        ServingEngine,
        TopicServer,
        document_theta0,
    )

    K, W = 1000, 500
    rng = np.random.default_rng(0)
    phi = rng.gamma(0.5, 1.0, (W, K)).astype(np.float32) * 100
    store = ParameterStore(str(tmp_path / "phi"), num_topics=K,
                           vocab_capacity=W, buffer_rows=0)
    store.write_rows(np.arange(W), phi)
    store.phi_k[:] = phi.sum(0)
    srv = TopicServer(store, LDAConfig(num_topics=K, vocab_size=W),
                      fit_sweeps=20, rel_tol=0.0, check_every=10,
                      vocab_pad=64, device=cuda)
    docs = []
    for n in rng.integers(20, 32, 12):
        w = rng.choice(W, size=int(n), replace=False).astype(np.int32)
        docs.append((w, rng.integers(1, 5, len(w)).astype(np.float32)))
    seeds = rng.integers(0, 2**32, len(docs)).tolist()
    with ServingEngine(srv, max_batch=16, bucket_multiple=32,
                       max_delay_ms=50.0, max_len=32) as eng:
        got = [f.result(timeout=120) for f in
               [eng.submit(w, c, seed=s) for (w, c), s in zip(docs, seeds)]]
    for th in got:
        np.testing.assert_allclose(th.sum(), 1.0, rtol=1e-5)
    order = list(range(len(docs)))[::-1]
    wp = np.zeros((16, 32), np.int32)
    cp = np.zeros((16, 32), np.float32)
    sp = np.full(16, -1, np.int64)
    for slot, i in enumerate(order):
        w, c = docs[i]
        wp[slot + 3, : len(w)] = w
        cp[slot + 3, : len(c)] = c
        sp[slot + 3] = seeds[i]
    stranger = rng.choice(W, size=30, replace=False)
    wp[0, :30], cp[0, :30], sp[0] = stranger, 2.0, 99
    direct = srv.infer(wp, cp, theta0=document_theta0(sp, cp, srv.cfg,
                                                      device=cuda))
    for slot, i in enumerate(order):
        assert np.array_equal(got[i], direct[slot + 3]), i
    # alone in a launch of the engine's shape, in another slot
    wa, ca, sa = np.zeros_like(wp), np.zeros_like(cp), np.full(16, -1)
    wa[9], ca[9], sa[9] = wp[3], cp[3], sp[3]
    alone = srv.infer(wa, ca, theta0=document_theta0(sa, ca, srv.cfg,
                                                     device=cuda))
    assert np.array_equal(alone[9], direct[3])


# ---------------------------------------------------------------------------
# Lifelong train-while-serve
# ---------------------------------------------------------------------------

def _lifelong_store(path, K, W, seed=7):
    from repro_torch.core import ParameterStore

    rng = np.random.default_rng(seed)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32) * 1e3
    store = ParameterStore(str(path), num_topics=K, vocab_capacity=W + 16,
                           buffer_rows=16)
    store.write_rows(np.arange(W), phi)
    store.phi_k[:] = phi.sum(0, dtype=np.float64)
    store.ensure_vocab(W - 1)
    return store


def test_lifelong_training_bitwise_under_traffic_on_card(cuda, tmp_path):
    """Training on the card while the engine serves every committed
    version gives the store bits and snapshot crcs of the same training
    without traffic; every θ carries a committed version."""
    import threading

    from repro_torch.core import FOEMTrainer, SnapshotPublisher
    from repro_torch.data import synthetic_lda_corpus
    from repro_torch.launch.serve import (
        ServingEngine, TopicServer, TrafficGenerator,
    )
    from repro_torch.sparse import MinibatchStream

    K, W = 64, 300
    corpus, _ = synthetic_lda_corpus(200, W, 8, mean_doc_len=24, seed=2)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=8,
                    active_topics=4)
    runs = []
    for traffic in (True, False):
        store = _lifelong_store(tmp_path / f"t{traffic}", K, W)
        pub = SnapshotPublisher(store, retain=2)
        crcs = {pub.publish().version: pub.latest().crc}
        tr = FOEMTrainer(cfg, store, seed=5, publisher=pub, publish_every=2,
                         device=cuda)
        stream = iter(MinibatchStream(corpus, 50, seed=1, epochs=None))
        got = []
        if traffic:
            srv = TopicServer(store, cfg, fit_sweeps=8, rel_tol=0.0,
                              check_every=8, vocab_pad=64, hot_rows=64,
                              device=cuda)
            srv.subscribe(pub)
            errors = []

            def train():
                try:
                    with torch.cuda.device(cuda):
                        tr.fit_stream(stream, max_steps=6, callback=lambda m:
                                      crcs.update({m.published_version:
                                                   pub.latest().crc}))
                except BaseException as e:
                    errors.append(e)

            trace = TrafficGenerator(W, doc_len=(4, 14), seed=9).trace(
                [(500.0, 80)])
            with ServingEngine(srv, max_batch=8, max_delay_ms=2.0,
                               max_len=16) as eng:
                th = threading.Thread(target=train)
                th.start()
                while th.is_alive():
                    got += [f.result(timeout=120) for f in
                            TrafficGenerator.replay(trace, eng.submit,
                                                    pace=False)]
                th.join(timeout=120)
                assert not th.is_alive() and not errors, errors
            committed = {r["version"] for r in pub.publish_log}
            assert got and all(t.version in committed for t in got)
        else:
            tr.fit_stream(stream, max_steps=6, callback=lambda m: crcs.update(
                {m.published_version: pub.latest().crc}))
        crcs.pop(-1, None)
        runs.append((store.dense_phi().copy(), store.phi_k.copy(), crcs))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] and sorted(runs[0][2]) == [1, 2, 3, 4]


def test_lifelong_refresh_step_launches_extra_dense_sweeps(cuda, tmp_path):
    """A step after a latched shift runs ``refresh_extra_sweeps`` more
    ``gs_sweep`` launches than the same step without it."""
    from repro_torch.core import FOEMTrainer, ShiftDetector
    from repro_torch.data import synthetic_lda_corpus
    from repro_torch.sparse import MinibatchStream

    K, W = 64, 300
    corpus, _ = synthetic_lda_corpus(100, W, 8, mean_doc_len=24, seed=3)
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=10,
                    active_topics=4)
    mb = next(iter(MinibatchStream(corpus, 50, seed=0)))
    counts = {}
    for refresh in (False, True):
        det = ShiftDetector(warmup=1)
        if refresh:
            det.update(step=0, residual_mass=1.0)
            det.update(step=1, residual_mass=2.0)    # fires: latched
        store = _lifelong_store(tmp_path / f"r{refresh}", K, W)
        tr = FOEMTrainer(cfg, store, seed=0, shift_detector=det,
                         refresh_extra_sweeps=3, device=cuda)
        before = gs_sweep.launches
        m = tr.step(mb)
        counts[refresh] = gs_sweep.launches - before
        assert m.scheduler_refresh is refresh
    assert counts[False] == cfg.warmup_sweeps
    assert counts[True] == counts[False] + 3


def test_lifelong_int8_server_close_to_f32_on_card(cuda, tmp_path):
    from repro_torch.core import SnapshotPublisher
    from repro_torch.launch.serve import TopicServer

    K, W = 1000, 500
    store = _lifelong_store(tmp_path / "q", K, W)
    pub = SnapshotPublisher(store)
    pub.publish()
    rng = np.random.default_rng(3)
    w = rng.integers(0, W, (64, 48)).astype(np.int32)
    c = rng.integers(1, 4, (64, 48)).astype(np.float32)
    out = {}
    for dtype in ("float32", "int8"):
        srv = TopicServer(store, LDAConfig(num_topics=K, vocab_size=W),
                          fit_sweeps=20, rel_tol=0.0, check_every=10,
                          vocab_pad=64, phi_dtype=dtype, hot_rows=128,
                          device=cuda)
        srv.subscribe(pub)
        out[dtype] = srv.infer(w, c)
        assert srv.last_version == 1
    assert np.isfinite(out["int8"]).all()
    assert np.abs(out["float32"] - out["int8"]).max() < 0.05


# ---------------------------------------------------------------------------
# The analysis layer on the card: launch contracts and the sanitizer
# ---------------------------------------------------------------------------

def _drive_every_contract(dev):
    """Launch every contracted kernel on each of its paths, small shapes."""
    for K, A, D in ((1000, 0, 9), (1000, 16, 9), (15_000, 0, 3),
                    (15_000, 4, 3), (50_000, 0, 2)):
        wid, est, ev, theta, phi, wt = _inputs(D, 20, K, 50, A, dev)
        for dtype in ("float32", "bfloat16", "int8"):
            store, scale = quantize_phi(phi, dtype)
            theta_sweep(wid, est, ev, theta, store, wt, scale,
                        alpha_m1=0.01, num_sweeps=2)
    for K in (256, 255, 10_241):
        args = _sweep_inputs(5, 6, K, 20, 0, dev)
        gs_sweep(*args, **SWEEP_KW, emit_loglik=True)
    sweep_loglik_partials(*(_sweep_inputs(5, 6, 777, 20, 0, dev)[i]
                            for i in (0, 1, 3, 4, 5)), **SWEEP_KW)
    args = _sweep_inputs(7, 6, 64, 20, 4, dev)
    scheduled_sweep(*args, **SWEEP_KW, emit_loglik=True)
    for K, A in ((64, 0), (63, 0), (64, 3)):
        args, rem, pm = _sharded_inputs(7, 6, K, 20, A, dev)
        sharded_probe(*args, **SWEEP_KW)
        sharded_fold(*_fold_args(args, rem, pm), **SWEEP_KW,
                     emit_loglik=True)
    for K in (100, 101, 10_241):
        th, ph, pt, ex, mu, cnt = _estep_inputs(37, K, 1, dev)
        for exclude, residual in ((True, True), (False, False)):
            fused_estep(th, ph, pt, ex if exclude else None,
                        mu if residual else None, cnt if residual else None,
                        **SWEEP_KW)
    topk_estep(*_topk_inputs(100, 16, dev), **SWEEP_KW)
    wid, cnt, mu, theta, phi, ptot, wt, act = _sweep_inputs(6, 8, 64, 20, 4,
                                                            dev)
    blocked_sweep(wid, cnt, wt, act, mu, theta, phi, ptot, num_blocks=2,
                  **SWEEP_KW)
    torch.cuda.synchronize()


def test_contracts_match_the_cards_launches_and_occupancy(cuda):
    """Every launch the wrappers make equals its contract's spec (variant,
    grid, threads, dynamic shared memory) built with the card's registers,
    and each predicted occupancy equals the runtime's."""
    from repro_torch.analysis import card, launches
    from repro_torch.analysis.contracts import CONTRACT_KERNELS
    from repro_torch.kernels import build

    libs = [k for k in build.KERNELS if k != "flash_attention"]
    for lib in libs:
        card.reset(lib)
    launches.clear()
    launches.enable()
    try:
        _drive_every_contract(cuda)
    finally:
        launches.enable(False)
    report = card.check_against_card(libs)
    print(json.dumps(report, indent=1))
    assert not report["mismatches"], "\n".join(report["mismatches"])
    assert {r["kernel"] for r in report["kernels"]} == set(CONTRACT_KERNELS)
    assert report["noted"] and report["recorded"]


def test_sanitizer_passes_and_fires_on_the_card(cuda):
    """debug_checks=True through the CUDA kernels: clean sweeps and a clean
    fit pass; a NaN φ row, a negative count and a perturbed φ̂(k) raise
    SanitizerError with the JAX package's messages.  φ̂ holds the
    minibatch's own mass (``consistent=True``): the independent draw does
    not, and its clean sweep rightly raises "negative values in phi_wk"
    (``tests/test_torch_sanitizer.py::test_sweep_inputs_need_their_own_mass``
    holds that on the CPU)."""
    from repro_torch.analysis import sanitizer

    args = _sweep_inputs(7, 6, 64, 20, 4, cuda, consistent=True)
    wid, cnt, mu, theta, phi, ptot, wt, act = args
    kw = dict(**SWEEP_KW, debug_checks=True, device=cuda)
    ops.sweep(wid, cnt, mu, theta, phi, ptot, compute_loglik=True, **kw)
    r = ops.sweep(wid, cnt, mu, theta, phi, ptot, word_topics=wt,
                  token_active=act, **kw)
    with pytest.raises(ops.SanitizerError,
                       match="phi_k deltas inconsistent"):
        sanitizer.sweep_invariants(
            r._replace(phi_k=r.phi_k + 1.0), counts=cnt, mu_before=mu,
            phi_wk_before=phi, phi_k_before=ptot, word_topics=wt,
            token_active=act, word_ids=wid)
    bad = cnt.clone()
    bad[0, 0] = -1.0
    with pytest.raises(ops.SanitizerError, match="negative values in"):
        ops.sweep(wid, bad, mu, theta, phi, ptot, **kw)
    wid, est, ev, theta, phin, _ = _inputs(9, 20, 1000, 50, 0, cuda)
    ikw = dict(alpha_m1=0.01, ev_counts=ev, max_sweeps=4, check_every=2,
               debug_checks=True, device=cuda)
    ops.infer(wid, est, theta, phin, **ikw)
    phin = phin.clone()
    phin[int(wid[0, 0])] = float("nan")
    with pytest.raises(ops.SanitizerError, match="non-finite values in"):
        ops.infer(wid, est, theta, phin, **ikw)
