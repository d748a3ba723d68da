"""The host-side preparation of the redesigned column loops, on the CPU.

The kernels on the card fold each column in visiting orders that their
wrappers build once per call on the device:

* ``gs_sweep.column_segments`` — the dense sweep's and dense sharded
  fold's row order: each column's live documents by word, stably, in
  compacted segments;
* ``scheduled_sweep.sorted_runs`` / ``fold_orders`` — the scheduled
  column loop's two orders: each column's live documents by word, and its
  live (document, active slot) pairs by topic (pair (d, a) at d·A + a),
  stably, each with its keys.

These tests hold each order to its definition on random inputs: every live
entry exactly once, sorted by key and stably in document order, -1 past a
column's last live entry.  A Python walk of the column loop in those orders
matches the plain versions, and on CPU tensors both wrappers run their plain
versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import scheduling
from repro_torch.kernels.gs_sweep import column_segments
from repro_torch.kernels.scheduled_sweep import (
    fold_orders,
    scheduled_sweep,
    scheduled_sweep_reference,
    sorted_runs,
)
from repro_torch.kernels.sharded_sweep import (
    sharded_fold,
    sharded_fold_reference,
)

KW = dict(alpha_m1=0.01, beta_m1=0.01, wb=20.0)


def _segments_of(out, l):
    """The segments of column l: [(word, [documents])], checking the -1
    padding past the column's count on the way."""
    order, pos, end, key, count = out
    n = int(count[l])
    assert bool((pos[l, n:] == -1).all()) and bool((end[l, n:] == -1).all())
    assert bool((key[l, n:] == -1).all())
    assert bool((pos[l, :n] >= 0).all())
    return [(int(key[l, s]), order[l, int(pos[l, s]):int(end[l, s])].tolist())
            for s in range(n)]


def _random(seed, D, L, W, A, K):
    rng = np.random.default_rng(seed)
    wid = torch.from_numpy(rng.integers(0, W, (D, L)).astype(np.int32))
    live = torch.from_numpy(rng.random((D, L)) > rng.uniform(0.1, 0.6))
    wt = torch.from_numpy(np.stack([rng.choice(K, A, replace=False)
                                    for _ in range(W)]).astype(np.int32))
    return wid, live, wt


@pytest.mark.parametrize("seed", range(4))
def test_column_segments_order_live_documents_by_word(seed):
    """Each column's live documents by word, stably, in compacted segments
    (-1 past the last), the dead ones in none; the dense folds' order."""
    D, L, W = 29, 6, 7
    wid, live, _ = _random(seed, D, L, W, 2, 9)
    out = column_segments(wid, live, W)
    assert all(t.dtype == torch.int32 for t in out)
    for l in range(L):
        segs = _segments_of(out, l)
        words = [w for w, _ in segs]
        assert words == sorted(set(words))               # one segment a word
        for w, docs in segs:
            assert docs == [d for d in range(D)
                            if bool(live[d, l]) and int(wid[d, l]) == w]
        assert sum(len(d) for _, d in segs) == int(live[:, l].sum())


def _check_runs(order, key, want, key_of, sentinel):
    """One column of a sorted order: the ``want`` entries exactly once,
    each beside its key, sorted by key, stably; -1 (and ``sentinel``) past
    the last of them."""
    n = len(want)
    assert bool((order[n:] == -1).all()) and bool((key[n:] == sentinel).all())
    o, k = order[:n].tolist(), key[:n].tolist()
    assert k == sorted(k)                                        # by key
    for i in range(1, n):
        if k[i] == k[i - 1]:
            assert o[i] > o[i - 1]                               # stable
    assert all(key_of(e) == kk for e, kk in zip(o, k))
    assert sorted(o) == want                                     # each once


@pytest.mark.parametrize("seed,A,K", [(0, 1, 5), (1, 3, 8), (2, 8, 8),
                                      (3, 4, 50), (4, 2, 40_000)])
def test_fold_orders_every_live_entry_once_by_key(seed, A, K):
    """Each column's live documents by word and live (document, slot)
    pairs by topic: every one exactly once, sorted, stably in document
    order; -1 past the column's last.  K = 40,000 takes the int32 sort
    keys; A = 1 once gave transposed strides (the kernel reads row by row:
    contiguous)."""
    D, L, W = 23, 5, 6
    wid, live, wt = _random(seed, D, L, W, A, K)
    row_order, row_key, pair_order, pair_key = fold_orders(wid, live, W,
                                                           wt, K)
    assert row_order.shape == row_key.shape == (L, D)
    assert pair_order.shape == pair_key.shape == (L, D * A)
    for t in (row_order, row_key, pair_order, pair_key):
        assert t.dtype == torch.int32 and t.is_contiguous()
    for l in range(L):
        docs = [d for d in range(D) if bool(live[d, l])]
        _check_runs(row_order[l], row_key[l], docs,
                    lambda d: int(wid[d, l]), W)
        _check_runs(pair_order[l], pair_key[l],
                    [d * A + a for d in docs for a in range(A)],
                    lambda e: int(wt[int(wid[e // A, l]), e % A]), K)


@pytest.mark.parametrize("sentinel", [9, 2 ** 15 + 3])
def test_sorted_runs(sentinel):
    """The primitive on an (L, N) key, both sort widths."""
    rng = np.random.default_rng(sentinel)
    key = torch.from_numpy(rng.integers(0, sentinel + 1, (4, 37)))
    order, skey = sorted_runs(key, sentinel)
    for l in range(4):
        want = [i for i in range(37) if int(key[l, i]) < sentinel]
        _check_runs(order[l], skey[l], want, lambda i: int(key[l, i]),
                    sentinel)


# ---------------------------------------------------------------------------
# The column loop walked in the orders, against the plain versions
# ---------------------------------------------------------------------------

def _inputs(seed, D, L, K, W, A):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 3).astype(np.float32)
    r = torch.from_numpy(rng.gamma(1.0, 1.0, (W, K)).astype(np.float32))
    wt = scheduling.select_active_topics(r, A).to(torch.int32)
    act = torch.from_numpy((rng.random((D, L)) > 0.25) & (cnt > 0))
    rem = torch.from_numpy(rng.gamma(1.0, 0.05, (D, L)).astype(np.float32))
    pm = torch.from_numpy(rng.random((D, L)).astype(np.float32) + 0.5)
    t = torch.from_numpy
    return (t(wid), t(cnt), t(mu), t(theta), t(phi), t(phi.sum(0)), wt, act,
            rem, pm)


def _walk(wid, cnt, mu, theta, phi, ptot, wt, act, rem=None, pm=None):
    """The scheduled column loop as the kernel runs it: a Jacobi E-step of
    the column's active tokens on their A lanes (Δ into the compact (D, A)
    scratch), then the φ̂ rows Δ by Δ in the row order and φ̂(k) topic run
    by topic run in the pair order, each run's total added once."""
    D, L = wid.shape
    K = mu.shape[-1]
    A = wt.shape[1]
    live = act & (cnt != 0)
    ro, rk, po, pk_key = fold_orders(wid, live, phi.shape[0], wt, K)
    mu_out, res = mu.clone(), torch.zeros_like(mu)
    th, ph, pk = theta.clone(), phi.clone(), ptot.clone()
    mass = torch.zeros_like(cnt)
    cp = torch.zeros(D * A)
    a1, b1, wb = KW["alpha_m1"], KW["beta_m1"], KW["wb"]
    for l in range(L):
        for d in range(D):
            if not act[d, l]:
                continue
            c, w = cnt[d, l], int(wid[d, l])
            ks = wt[w].long()
            m0 = mu[d, l, ks]
            ex = c * m0
            num = (((th[d, ks] - ex).clamp_min(0) + a1)
                   * ((ph[w, ks] - ex).clamp_min(0) + b1) / (pk[ks] - ex + wb))
            if rem is None:
                m = num / num.sum().clamp_min(1e-30) * m0.sum()
            else:
                m = num / (rem[d, l] + num.sum()).clamp_min(1e-30) * pm[d, l]
            dl = c * (m - m0)
            mu_out[d, l, ks], res[d, l, ks], mass[d, l] = m, dl.abs(), m.sum()
            if c != 0:
                th[d, ks] += dl
                cp[d * A:(d + 1) * A] = dl
        words = rk[l].tolist()
        for q, w in enumerate(words):           # a word's documents, Δ by Δ
            if int(ro[l, q]) >= 0 and (q == 0 or words[q - 1] != w):
                run = [int(ro[l, r]) for r in range(q, D)
                       if words[r] == w and int(ro[l, r]) >= 0]
                for a in range(A):
                    k = int(wt[w, a])
                    for d in run:
                        ph[w, k] = ph[w, k] + cp[d * A + a]
        keys = pk_key[l].tolist()
        for q, k in enumerate(keys):            # a topic's run, in order
            if int(po[l, q]) >= 0 and (q == 0 or keys[q - 1] != k):
                run = [int(po[l, r]) for r in range(q, len(keys))
                       if keys[r] == k]
                pk[k] = pk[k] + cp[run].sum()
    return mu_out, res, th, ph, pk, mass


def _close(got, want):
    for a, b in zip(got, want):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("D,L,K,W,A", [(9, 6, 13, 4, 3), (16, 5, 20, 6, 1),
                                       (8, 4, 10, 5, 10)])
def test_walk_in_fold_orders_matches_plain(D, L, K, W, A):
    """The loop in the wrappers' orders gives the plain versions' outputs
    (within the sweep tolerance: φ̂(k) sums its Δ in another order)."""
    args = _inputs(D + K, D, L, K, W, A)
    base = args[:8]
    want = scheduled_sweep_reference(*base, **KW)
    _close(_walk(*base)[:5], want[:5])
    rem, pm = args[8], args[9]
    want = sharded_fold_reference(*base[:6], rem, pm, *base[6:], **KW)
    _close(_walk(*base, rem, pm), want[:6])


@pytest.mark.parametrize("scheduled", [False, True])
def test_wrappers_run_plain_versions_on_cpu(scheduled):
    """CPU tensors take the plain versions: the same outputs, no kernel
    call counted."""
    args = _inputs(3, 7, 5, 12, 4, 3)
    before = (scheduled_sweep.launches, sharded_fold.launches)
    base, rem, pm = args[:8], args[8], args[9]
    fargs = (*base[:6], rem)
    if scheduled:
        got = scheduled_sweep(*base, **KW, emit_loglik=True)
        want = scheduled_sweep_reference(*base, **KW, emit_loglik=True)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        fargs = (*base[:6], rem, pm, *base[6:])
    got = sharded_fold(*fargs, **KW, emit_loglik=True)
    want = sharded_fold_reference(*fargs, **KW, emit_loglik=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert (scheduled_sweep.launches, sharded_fold.launches) == before
