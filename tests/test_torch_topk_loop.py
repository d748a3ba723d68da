"""The block loop of ``topk_estep.blocked_sweep`` on the CPU: its plan, and a
Python walk of it against the plain version.

On the card one persistent launch runs a blocked or ``"scan"`` scheduled
sweep: per block of nb = ⌈L/B⌉ columns a Jacobi E-step of every token on
its word's A active lanes against the pre-block statistics, θ̂ folded
document by document in column order, then the φ̂ rows and φ̂(k) folded in
visiting orders that the wrapper builds once per call
(``topk_estep.block_orders``): each block's live non-lone entries by word
with the word runs' bounds, its live (entry, slot) pairs by topic, entry
d·nb + c, and the lone tokens (``solo``) whose row the E-step folds
itself.

These tests hold the plan to its definition on random inputs, walk the
loop in it in Python and compare with ``blocked_sweep_reference`` (the
blocked scan of the JAX package's ``scheduled_iem_sweep``; the blocked
tests against the JAX package are ``tests/test_torch_blocked.py``) at
B = L, a ragged B = 3 and B = 1, and check that CPU tensors run the plain
version and that no input is modified.  Tolerance: rtol 2e-5, atol 1e-5
scaled by the array's magnitude (``tests/test_torch_blocked.py``'s for
one sweep): the walk sums φ̂(k)'s Δ in another order than the plain
version's serial ``index_add_``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.topk_estep import (
    block_orders,
    block_width,
    blocked_sweep,
    blocked_sweep_reference,
)

KW = dict(alpha_m1=0.01, beta_m1=0.01, wb=20.0)


def _random(seed, D, L, W, A, K):
    rng = np.random.default_rng(seed)
    wid = torch.from_numpy(rng.integers(0, W, (D, L)).astype(np.int32))
    live = torch.from_numpy(rng.random((D, L)) > rng.uniform(0.1, 0.6))
    wt = torch.from_numpy(np.stack([rng.choice(K, A, replace=False)
                                    for _ in range(W)]).astype(np.int32))
    return wid, live, wt


def _check_runs(order, key, want, key_of, sentinel):
    """One block of a sorted order: the ``want`` entries exactly once,
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


@pytest.mark.parametrize("seed,L,B,A,K", [(0, 7, 3, 2, 9), (1, 6, 6, 3, 8),
                                          (2, 5, 1, 4, 50), (3, 9, 4, 1, 5),
                                          (4, 4, 2, 2, 40_000)])
def test_block_orders_every_live_entry_once_by_key(seed, L, B, A, K):
    """Per block: the lone live tokens, every other live entry by word (its
    word runs' bounds compacted) and every live (entry, slot) pair by
    topic, exactly once, stably in (d, c) order, -1 past the block's last.
    B = 3 at L = 7 leaves a ragged last block; K = 40,000 takes the int32
    sort keys."""
    D, W = 11, 5
    wid, live, wt = _random(seed, D, L, W, A, K)
    solo, row_order, row_key, run_pos, run_end, pair_order, pair_key = \
        block_orders(wid, live, W, wt, K, B)
    nb, blocks = block_width(L, B)
    assert solo.shape == (D, L) and solo.dtype == torch.bool
    assert row_order.shape == row_key.shape == (blocks, D * nb)
    assert run_pos.shape == run_end.shape == (blocks, D * nb)
    assert pair_order.shape == pair_key.shape == (blocks, D * nb * A)
    for t in (row_order, row_key, run_pos, run_end, pair_order, pair_key):
        assert t.dtype == torch.int32 and t.is_contiguous()
    for b in range(blocks):
        cols = range(b * nb, min(L, (b + 1) * nb))
        words = [int(wid[d, c]) for d in range(D) for c in cols]
        for d in range(D):
            for c in cols:
                alone = words.count(int(wid[d, c])) == 1   # dead or live
                assert bool(solo[d, c]) == (bool(live[d, c]) and alone)
        ent = [d * nb + c - b * nb for d in range(D) for c in cols
               if bool(live[d, c])]

        def word(e):
            return int(wid[e // nb, b * nb + e % nb])

        rows = [e for e in ent if not bool(solo[e // nb, b * nb + e % nb])]
        _check_runs(row_order[b], row_key[b], rows, word, W)
        # the word runs: one a word, compacted, covering the rows' entries
        n = int((run_pos[b] >= 0).sum())
        assert bool((run_pos[b, n:] == -1).all())
        assert bool((run_end[b, n:] == -1).all())
        spans = list(zip(run_pos[b, :n].tolist(), run_end[b, :n].tolist()))
        assert [q for span in spans for q in range(*span)] == list(
            range(len(rows)))
        assert [int(row_key[b, q]) for q, _ in spans] == sorted(
            {word(e) for e in rows})
        for q0, q1 in spans:
            assert len({int(k) for k in row_key[b, q0:q1]}) == 1
        _check_runs(pair_order[b], pair_key[b],
                    [e * A + a for e in ent for a in range(A)],
                    lambda p: int(wt[word(p // A), p % A]), K)


# ---------------------------------------------------------------------------
# The block loop walked in the plan, against the plain version
# ---------------------------------------------------------------------------

def _inputs(seed, D, L, K, W, A, shared_topics=False):
    """Shared words across documents and columns, zero-count and inactive
    tokens, and pad lanes: topic 0 carries no μ and no θ̂ in the first two
    documents, where every word has it active.  ``shared_topics``: K = A +
    1, so a document's tokens share topics within a block."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    cnt[:, -1] = 0.0
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    mu[:2, :, 0] = 0.0                                    # pad lanes
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (W, K)) * 3).astype(np.float32)
    if shared_topics:
        assert K == A + 1
    wt = np.stack([np.concatenate([[0], 1 + rng.choice(K - 1, A - 1,
                                                       replace=False)])
                   for _ in range(W)]).astype(np.int32)
    act = (rng.random((D, L)) > 0.25) & (cnt > 0)
    act[2, 0] = True                                      # active, count 0
    cnt[2, 0] = 0.0
    t = torch.from_numpy
    return (t(wid), t(cnt), t(wt), t(act), t(mu), t(theta), t(phi),
            t(phi.sum(0)))


def _walk(wid, cnt, wt, act, mu, theta, phi, ptot, B):
    """The block loop as the kernel runs it: per block, each document's
    tokens E-step on the pre-block θ̂_d, φ̂ and φ̂(k) (a lone token adds
    its Δ to its row at once), θ̂_d folds column by column, then the φ̂
    rows Δ by Δ over each word run of the row order and φ̂(k) topic run by
    topic run in the pair order, each run's total added once."""
    D, L = wid.shape
    A = wt.shape[1]
    nb, blocks = block_width(L, B)
    live = act & (cnt != 0)
    solo, ro, rk, run_pos, run_end, po, pkey = block_orders(
        wid, live, phi.shape[0], wt, mu.shape[-1], B)
    mu_out = mu.clone()
    absd = torch.zeros((D, L, A))
    th, ph, pk = theta.clone(), phi.clone(), ptot.clone()
    a1, b1, wb = KW["alpha_m1"], KW["beta_m1"], KW["wb"]
    for b in range(blocks):
        cp = torch.zeros(D * nb * A)
        cols = range(b * nb, min(L, (b + 1) * nb))
        for d in range(D):
            th0 = th[d].clone()                  # the pre-block θ̂_d
            for c in cols:
                if not act[d, c]:
                    continue
                x, w = cnt[d, c], int(wid[d, c])
                ks = wt[w].long()
                m0 = mu[d, c, ks]
                ex = x * m0
                num = (((th0[ks] - ex).clamp_min(0) + a1)
                       * ((ph[w, ks] - ex).clamp_min(0) + b1)
                       / (pk[ks] - ex + wb))
                num = torch.where((m0 <= 0) & (th0[ks] <= 0), 0.0, num)
                m = num / num.sum().clamp_min(1e-30) * m0.sum()
                dl = x * (m - m0)
                mu_out[d, c, ks], absd[d, c] = m, dl.abs()
                e = d * nb + c - b * nb
                cp[e * A:(e + 1) * A] = dl
                if solo[d, c]:
                    ph[w, ks] += dl
            for c in cols:                       # θ̂_d in column order
                if live[d, c]:
                    e = d * nb + c - b * nb
                    th[d, wt[int(wid[d, c])].long()] += cp[e * A:(e + 1) * A]
        for q0, q1 in zip(run_pos[b].tolist(), run_end[b].tolist()):
            if q0 < 0:                           # a word run, Δ by Δ
                break
            w = int(rk[b, q0])
            for a in range(A):
                k = int(wt[w, a])
                for e in ro[b, q0:q1].tolist():
                    ph[w, k] = ph[w, k] + cp[e * A + a]
        keys = pkey[b].tolist()
        for q, k in enumerate(keys):             # a topic's run, in order
            if int(po[b, q]) >= 0 and (q == 0 or keys[q - 1] != k):
                run = [int(po[b, r]) for r in range(q, len(keys))
                       if keys[r] == k]
                pk[k] = pk[k] + cp[run].sum()
    return th, ph, pk, mu_out, absd, wt[wid.long()]


def _close(got, want):
    for a, b in zip(got, want):
        if not a.is_floating_point():
            assert torch.equal(a, b)
            continue
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("D,L,K,W,A,shared", [
    (9, 6, 13, 4, 3, False), (12, 7, 20, 6, 4, False),
    (8, 5, 5, 3, 4, True), (16, 4, 30, 40, 2, False)])
@pytest.mark.parametrize("B", ["L", 3, 1])
def test_walk_in_block_orders_matches_plain(D, L, K, W, A, shared, B):
    """The loop in the wrapper's plan gives the plain version's outputs at
    B = L (the scan), a ragged B = 3 and B = 1 (one Jacobi block); W = 40
    > D·L/2 leaves many words alone in their block."""
    B = L if B == "L" else B
    args = _inputs(D * K + L, D, L, K, W, A, shared)
    want = blocked_sweep_reference(*args, num_blocks=B, **KW)
    _close(_walk(*args, B), want)
    absd = want[4]
    act = args[3]
    assert bool((absd[~act] == 0).all())
    assert bool((absd[args[1] == 0] == 0).all())             # inert slots
    assert torch.equal(want[3][~act], args[4][~act])
    pad = want[3][:2, :, 0]
    assert bool((pad == 0).all())                            # pad lanes


@pytest.mark.parametrize("B", [2, 5])
def test_blocked_sweep_runs_plain_version_on_cpu(B):
    """CPU tensors take the plain version: the same outputs, no kernel
    launch counted, no input modified."""
    args = _inputs(7, 10, 5, 12, 4, 3)
    before = [x.clone() for x in args]
    launches = blocked_sweep.launches
    got = blocked_sweep(*args, num_blocks=B, **KW)
    want = blocked_sweep_reference(*args, num_blocks=B, **KW)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert blocked_sweep.launches == launches
    for x, y in zip(args, before):
        assert torch.equal(x, y)


@pytest.mark.parametrize("L,B,nb,blocks", [(128, 8, 16, 8), (128, 128, 1, 128),
                                           (10, 4, 3, 4), (10, 6, 2, 5),
                                           (7, 0, 7, 1), (5, 9, 1, 5)])
def test_block_width(L, B, nb, blocks):
    """⌈L/B⌉ columns a block (B clamped to [1, L]), ⌈L/nb⌉ blocks."""
    assert block_width(L, B) == (nb, blocks)
