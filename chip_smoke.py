#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (one ``nvcc`` per source, all started together) and then, in
order:

1. holds the frozen-φ ``theta_sweep`` kernel against its plain PyTorch
   version at the serving path's shapes (K = 10,000 topics, 256 documents
   of 64–256 tokens);
2. drives the serving path — ``TopicServer`` over a disk-backed
   ``ParameterStore`` at the ``stream_1k`` width (capacity W = 141,043 rows
   × K = 10,000, 5.6 GB of float32 written to ``build/``, deleted at the
   end) — and checks the answers; one warm batch runs under
   ``torch.profiler``;
3. holds the two training sweep kernels (``gs_sweep``, ``scheduled_sweep``)
   against their plain versions at the ``stream_1k`` training shapes (one
   bucketed 1,024 × 128 minibatch, K = 10,000, A = 16), with and without
   the stop-rule phase;
4. drives the training path — ``FOEMTrainer(device="cuda")`` for three
   minibatches of ``lda_config(stream_1k)`` on the same store, then one
   more step under ``torch.profiler`` — and serves a batch from the
   trained store.

Each path's kernel launch counters are set to 0 just before it and read
just after.  Any failed check exits non-zero before the result lines.  The
last two lines of standard output are a ``{"kernels": [...]}`` JSON object
and the device record ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
and prints no result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

D_KERNEL = 256              # documents per checked kernel launch
K_FULL = 10_000             # stream_1k topics
W_FULL = 141_043            # stream_1k vocabulary (store capacity)
DOC_LEN = (64, 256)         # tokens per request
SWEEPS = 10                 # one check_every chunk
A_SCHED = 16                # active topics of the scheduled variant
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
# Kernel vs plain tolerances (rtol, atol) and why.
TOL = {"theta": (1e-4, 1e-4), "est_ll": (1e-4, 1e-3), "ev_ll": (1e-4, 1e-3)}
TOL_REASON = (
    "theta is in token units (a row sums to the document's estimation "
    "tokens), so atol 1e-4 is 1e-4 of one token's mass; the partials "
    "x*log(lik) are in nats (atol 1e-3); rtol 1e-4 covers float32 sums of "
    "K = 1e4 terms taken in another order (~log2(K)*2^-24 = 1e-6 per sum) "
    "carried through 10 sweeps, with a 10x margin")
D_TRAIN = 1024              # stream_1k minibatch documents
L_TRAIN = 128               # stream_1k bucket length
# Sweep kernel vs plain tolerances (rtol, atol) and why.
SWEEP_TOL = {"mu": (1e-4, 1e-6), "residual": (1e-4, 1e-5),
             "theta": (1e-4, 1e-4), "phi_wk": (1e-4, 1e-3),
             "phi_k": (1e-5, 1.0), "loglik": (1e-5, 0.0)}
SWEEP_TOL_REASON = (
    "mu is a probability (atol 1e-6 against float32's 6e-8 at 1); the "
    "residual is counts*|dmu| (<= 4 tokens here: atol 1e-5); theta is in "
    "token units (atol 1e-4 of one token); phi_wk rows hold up to ~1e6 "
    "tokens (atol 1e-3, rtol 1e-4); phi_k holds ~5e4 tokens per topic "
    "(one float32 ulp ~4e-3) and each of the 128 columns adds a sum of "
    "1,024 deltas taken in another order, a few ulps apart (rtol 1e-5, "
    "atol 1 token); the loglik sums 1e5 token partials (rtol 1e-5). "
    "rtol 1e-4 elsewhere covers K = 1e4 term sums in another order carried "
    "through 128 Gauss-Seidel columns")
PHI_K_SUM_RTOL = 1e-4       # phi_k against sum_w phi_wk after a sweep:
# two float32 sums of ~2e4 rows of ~1e4-token magnitude in different orders


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()                                    # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(torch, fn):
    """Run ``fn`` once under ``torch.profiler``.  Returns its result, the
    host wall ms, the device ms by operation (largest first) and the busy
    ms: the union of the device events' intervals."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    by_op, busy_us, cur = {}, 0.0, None
    for s, e, name in events:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e3
        if cur is None or s > cur[1]:
            busy_us += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += 0.0 if cur is None else cur[1] - cur[0]
    by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    return out, wall_ms, by_op, busy_us / 1e3


def errors(got, want) -> dict:
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    return {"max_abs": float(diff.max()), "max_rel": float(rel.max())}


def kernel_phase(torch, dev, report):
    """Kernel vs plain version, four variants, at the serving shapes."""
    import numpy as np

    from repro_torch.core import em
    from repro_torch.core.perplexity import (
        init_theta, serving_active_topics, split_heldout_counts,
    )
    from repro_torch.core.types import LDAConfig, MinibatchData
    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.kernels.theta_sweep import (
        quantize_phi, theta_sweep, theta_sweep_reference,
    )
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import bucketize, localize_vocab

    gen = TrafficGenerator(vocab_size=W_FULL, doc_len=DOC_LEN, seed=1)
    corpus = gen.corpus(D_KERNEL)
    w, c = bucketize(corpus, list(range(D_KERNEL)), pad_multiple=16)
    uniq, local = localize_vocab(w)
    est, ev = split_heldout_counts(c, np.random.default_rng(2))
    Ws = len(uniq)
    rows = np.concatenate(list(trained_like_phi_blocks(
        Ws, K_FULL, ranks=gen.word_ranks()[uniq], seed=3)))
    cfg = LDAConfig(num_topics=K_FULL, vocab_size=W_FULL)
    phi_k = torch.from_numpy(rows.sum(0) * (W_FULL / Ws)).to(dev)
    phi_norm = em.normalize_phi(torch.from_numpy(rows).to(dev), phi_k, cfg)
    wid_t = torch.from_numpy(local).to(dev)
    est_t = torch.from_numpy(est).to(dev)
    ev_t = torch.from_numpy(ev).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    theta0 = init_theta(g, MinibatchData(wid_t, est_t), cfg)
    L = local.shape[1]
    fit_tok = int((est > 0).sum())
    ev_tok = int(((est > 0) | (ev > 0)).sum())
    rows_used = len(np.unique(local[(est > 0) | (ev > 0)]))
    print(f"kernel shapes: D={D_KERNEL} L={L} K={K_FULL} W_s={Ws} "
          f"fit tokens={fit_tok} eval tokens={ev_tok} sweeps={SWEEPS}")
    print(f"tolerance (rtol, atol): {json.dumps(TOL)}: {TOL_REASON}")

    variants = []
    for name, dtype, sched in (("f32 dense", "float32", False),
                               ("f32 scheduled A=16", "float32", True),
                               ("bf16 dense", "bfloat16", False),
                               ("int8 dense", "int8", False)):
        phi, scale = quantize_phi(phi_norm, dtype)
        wt = serving_active_topics(phi_norm, A_SCHED) if sched else None
        args = (wid_t, est_t, ev_t, theta0, phi, wt, scale)
        kw = dict(alpha_m1=cfg.alpha_m1, num_sweeps=SWEEPS)
        got = theta_sweep(*args, **kw)
        torch.cuda.synchronize()
        want = theta_sweep_reference(*args, **kw)
        errs = {}
        for key, a, b in zip(("theta", "est_ll", "ev_ll"), got, want):
            rtol, atol = TOL[key]
            errs[key] = errors(a, b)
            ok = bool(torch.allclose(a, b, rtol=rtol, atol=atol))
            check(ok, f"{name}: {key} disagrees with the plain version "
                      f"{errs[key]} beyond rtol {rtol} / atol {atol}")
        again = theta_sweep(*args, **kw)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{name}: two launches on the same inputs differ")
        ms = cuda_time_ms(lambda: theta_sweep(*args, **kw), 5)
        plain_ms = cuda_time_ms(lambda: theta_sweep_reference(*args, **kw), 2)
        # least time: each input read once, each output written once (φ:
        # the rows this data touches), against the float32 operations
        lanes = A_SCHED if sched else K_FULL
        nbytes = (3 * D_KERNEL * L * 4 + 2 * D_KERNEL * K_FULL * 4
                  + 2 * D_KERNEL * L * 4 + rows_used * K_FULL * phi.element_size()
                  + (rows_used * 4 if scale is not None else 0)
                  + (rows_used * A_SCHED * 4 if sched else 0))
        flops = (5 * lanes * fit_tok * SWEEPS + 2 * K_FULL * ev_tok
                 + 3 * D_KERNEL * K_FULL * (SWEEPS + 1))
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = flops / FP32_FLOPS * 1e3
        gather = (SWEEPS * fit_tok * lanes + ev_tok * K_FULL) * phi.element_size()
        rec = {"variant": name, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(b_ms, o_ms),
               "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "row_gather_bytes": gather,
               "row_gather_ms_at_hbm_rate": gather / HBM_BYTES_PER_S * 1e3,
               "errors": errs}
        variants.append(rec)
        print("kernel " + json.dumps(rec))
        if name == "f32 dense":
            # a document's θ̂ does not depend on its batch-mates: the first
            # 64 documents alone give the same bits
            part = theta_sweep(wid_t[:64].contiguous(), est_t[:64].contiguous(),
                               ev_t[:64].contiguous(), theta0[:64].contiguous(),
                               phi, None, None, **kw)
            check(all(torch.equal(x, y[:64]) for x, y in zip(part, got)),
                  "f32 dense: a document's θ̂ depends on its batch-mates")
    report["variants"] = variants

    # bigmodel's K = 5·10⁴: 3·K floats per document exceed shared memory and
    # the same kernel keeps them in a global scratch
    Kb, Db = 50_000, min(32, D_KERNEL)
    rng = np.random.default_rng(4)
    phib = torch.from_numpy(rng.gamma(0.3, 1.0, (Ws, Kb)).astype(np.float32))
    phib = (phib / phib.sum(0, keepdim=True)).to(dev)
    thb = torch.from_numpy(rng.gamma(1.0, 1.0, (Db, Kb)).astype(np.float32))
    argb = (wid_t[:Db].contiguous(), est_t[:Db].contiguous(),
            ev_t[:Db].contiguous(), thb.to(dev), phib)
    kw = dict(alpha_m1=cfg.alpha_m1, num_sweeps=2)
    got = theta_sweep(*argb, **kw)
    torch.cuda.synchronize()
    want = theta_sweep_reference(*argb, **kw)
    for key, a, b in zip(("theta", "est_ll", "ev_ll"), got, want):
        rtol, atol = TOL[key]
        check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
              f"K={Kb} global-scratch path: {key} disagrees "
              f"{errors(a, b)}")
    print(f"kernel K={Kb} D={Db} (global scratch): agrees with the plain "
          f"version, max abs err "
          f"{max(errors(a, b)['max_abs'] for a, b in zip(got, want)):.3g}")
    del phi_norm, phi, theta0, phib, thb, argb, got, want
    torch.cuda.empty_cache()


def make_store(store_dir, report):
    """The stream_1k serving/training store: trained-like random φ̂ rows
    from a seed, written straight into the memmap under ``build/``."""
    from repro_torch.core.streaming import store_from_arrays
    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.launch.serve import TrafficGenerator

    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.parent.mkdir(parents=True, exist_ok=True)
    cap = W_FULL
    free = shutil.disk_usage(store_dir.parent).free
    need = cap * K_FULL * 4
    if free < need + (4 << 30):
        cap = int((free - (4 << 30)) // (K_FULL * 4))
        check(cap > 16_384, f"only {free} bytes free for the store")
        print(f"store capacity cut from {W_FULL} to {cap} rows: "
              f"{free} bytes free on disk")
    report["store_capacity"] = cap
    gen = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN, seed=7)
    t0 = time.perf_counter()
    store = store_from_arrays(
        str(store_dir), trained_like_phi_blocks(
            cap, K_FULL, ranks=gen.word_ranks(), seed=0),
        live_vocab=cap, vocab_capacity=cap)
    report["store_write_s"] = time.perf_counter() - t0
    print(f"store written: {cap} x {K_FULL} float32 "
          f"({cap * K_FULL * 4 / 1e9:.2f} GB) in "
          f"{report['store_write_s']:.1f} s")
    return store, gen


def serving_phase(torch, store, gen, report):
    """The serving main path at the stream_1k width."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.perplexity import split_heldout_counts
    from repro_torch.kernels.theta_sweep import theta_sweep
    from repro_torch.launch.serve import TopicServer
    from repro_torch.sparse import bucketize

    cfg = lda_config(lda_shape("stream_1k"))
    B = 256
    corpus = gen.corpus(5 * B)

    theta_sweep.launches = 0          # counts of the main path only
    srv = TopicServer(store, cfg, device="cuda")
    lat, fetch, fit, sweeps = [], [], [], []
    stream = srv.infer_stream(corpus, list(range(3 * B)), B)
    for _ in range(3):
        t0 = time.perf_counter()
        chunk, theta = next(stream)
        lat.append(time.perf_counter() - t0)
        fetch.append(srv.last_seconds["fetch"])
        fit.append(srv.last_seconds["fit"])
        sweeps.append(srv.last_sweeps)
        check(theta.shape == (B, K_FULL) and np.isfinite(theta).all(),
              "served θ has the wrong shape or is not finite")
        check(np.allclose(theta.sum(-1), 1.0, rtol=1e-4),
              "served θ rows do not sum to 1")
    w, c = bucketize(corpus, list(range(3 * B, 4 * B)), pad_multiple=16)
    t1 = srv.infer(w, c)
    # the same (warm) batch again, under the profiler: where its time goes
    t2, wall_ms, by_op, busy_ms = device_profile(
        torch, lambda: srv.infer(w, c))
    check(np.array_equal(t1, t2), "identical requests gave different θ")
    profiled = {"wall_ms": wall_ms,
                "fetch_ms": srv.last_seconds["fetch"] * 1e3,
                "fit_ms": srv.last_seconds["fit"] * 1e3,
                "sweeps": srv.last_sweeps,
                "device_busy_ms": busy_ms if by_op else None,
                "device_busy_share": busy_ms / wall_ms if by_op else None,
                "device_ms_by_op": {k[:80]: v for k, v in
                                    list(by_op.items())[:10]}}
    print("profiled batch " + json.dumps(profiled) if by_op else
          "profiled batch: device time not measured (no device events)")
    est, ev = split_heldout_counts(c, np.random.default_rng(5))
    _, ppl = srv.evaluate(w, est, ev)
    check(np.isfinite(ppl) and 1.0 < ppl < cfg.W,
          f"eq. 21 perplexity {ppl} is not finite and in (1, W)")

    hot = TopicServer(store, cfg, hot_rows=16_384, device="cuda")
    w2, c2 = bucketize(corpus, list(range(4 * B, 5 * B)), pad_multiple=16)
    hot.infer(w, c)
    t_hot = hot.infer(w2, c2)
    check(np.isfinite(t_hot).all(), "hot-row-cache θ is not finite")
    hit_rate = hot.hot_cache.stats.hit_rate

    q = TopicServer(store, cfg, phi_dtype="int8", device="cuda")
    _, ppl_q = q.evaluate(w, est, ev)
    check(np.isfinite(ppl_q), "int8 eq. 21 perplexity is not finite")
    launches = theta_sweep.launches
    check(launches > 0, "the serving path launched no theta_sweep kernel")
    report["heldout"] = (w, est, ev)

    lat_ms = [x * 1e3 for x in lat]
    rec = {"batch_docs": B, "batch_ms": lat_ms,
           "fetch_ms": [x * 1e3 for x in fetch],
           "fit_ms": [x * 1e3 for x in fit], "sweeps": sweeps,
           "docs_per_s": B * len(lat) / sum(lat),
           "eq21_ppl_f32": ppl, "eq21_ppl_int8": ppl_q,
           "int8_drift": ppl_q / ppl - 1.0, "hot_cache_hit_rate": hit_rate,
           "store_write_s": report["store_write_s"], "launches": launches}
    print("serving " + json.dumps(rec))
    report["serving"] = rec


def _sweep_bound_ms(D, L, K, rows_used, live_tokens, lanes, A,
                    loglik) -> tuple:
    """Least time of one sweep on these inputs: each input read once and
    each output written once — μ (D·L·K) in, μ_new and the residual out,
    θ̂ and the touched φ̂ rows in and out, φ̂(k), the token ids and counts
    (+ the active sets and λ_w mask) — against ≈ 21 float32 operations
    per computed (token, lane) entry (+ 7 per (live token, topic) for the
    stop rule)."""
    nbytes = (3 * D * L * K * 4 + 2 * D * L * 4 + 2 * D * K * 4
              + 2 * rows_used * K * 4 + 2 * K * 4)
    if A:
        nbytes += rows_used * A * 4 + D * L
    flops = 21 * lanes + (7 * live_tokens * K if loglik else 0)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_FLOPS * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def sweep_kernel_phase(torch, dev, store, report):
    """Both training sweep kernels against their plain versions at the
    stream_1k training shapes: one bucketed 1,024 × 128 minibatch from the
    store, its minibatch-start state, then a post-warm-up scheduled
    state."""
    import numpy as np

    from repro_torch.core import em, scheduling
    from repro_torch.core.types import uniform_responsibilities
    from repro_torch.kernels.gs_sweep import gs_sweep, gs_sweep_reference
    from repro_torch.kernels.scheduled_sweep import (
        scheduled_sweep, scheduled_sweep_reference,
    )
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    gen = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                           seed=3)
    mb = next(iter(MinibatchStream(gen.corpus(D_TRAIN), D_TRAIN,
                                   bucket_len=L_TRAIN, seed=0)))
    Ws = len(mb.local_vocab)
    wid = torch.from_numpy(mb.local_word_ids).to(dev)
    cnt = torch.from_numpy(mb.counts).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    mu = uniform_responsibilities(g, (D_TRAIN, L_TRAIN, K_FULL))
    theta = em.fold_theta(mu, cnt)
    phi = torch.from_numpy(store.fetch_rows(mb.local_vocab)).to(dev)
    phi = phi + em.fold_phi(mu, cnt, wid, Ws)[0]
    ptot = phi.sum(0)                       # a consistent local view
    wb = W_FULL * 0.01
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=wb)
    live = mb.counts > 0
    rows_used = len(np.unique(mb.local_word_ids[live]))
    live_tok = int(live.sum())
    print(f"sweep kernel shapes: D={D_TRAIN} L={L_TRAIN} K={K_FULL} "
          f"W_s={Ws} live tokens={live_tok} rows touched={rows_used} "
          f"A={A_SCHED}")
    print(f"sweep tolerance (rtol, atol): {json.dumps(SWEEP_TOL)}: "
          f"{SWEEP_TOL_REASON}")

    # the post-warm-up state the scheduled sweeps start from: one dense
    # sweep, its residuals ranked into the eq. 36 active sets
    warm = gs_sweep(wid, cnt, mu, theta, phi, ptot, **kw)
    sched = scheduling.residuals_from_sweep(warm[1], wid, Ws)
    wt = scheduling.select_active_topics(sched.r_wk, A_SCHED)
    act = cnt > 0
    post = (warm[0], warm[2], warm[3], warm[4])
    del warm, sched
    names = ("mu", "residual", "theta", "phi_wk", "phi_k", "loglik")
    variants = []
    for name, fn, ref, extra in (
            ("dense", gs_sweep, gs_sweep_reference, None),
            ("scheduled A=16", scheduled_sweep, scheduled_sweep_reference,
             (wt, act))):
        args = ((wid, cnt, mu, theta, phi, ptot) if extra is None
                else (wid, cnt) + post + extra)
        for loglik in (False, True):
            vkw = dict(kw, emit_loglik=loglik)
            got = fn(*args, **vkw)
            torch.cuda.synchronize()
            want = ref(*args, **vkw)
            errs = {}
            for key, a, b in zip(names, got, want):
                if a is None:
                    continue
                rtol, atol = SWEEP_TOL[key]
                errs[key] = errors(a, b)
                check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
                      f"{name} sweep: {key} disagrees with the plain "
                      f"version {errs[key]} beyond rtol {rtol} / atol {atol}")
            del want
            again = fn(*args, **vkw)
            check(all(torch.equal(x, y) for x, y in zip(got, again)
                      if x is not None),
                  f"{name} sweep: two launches on the same inputs differ")
            del again
            zero = cnt == 0
            check(float(got[1][zero].abs().max()) == 0.0,
                  f"{name} sweep: a zero-count slot has a residual")
            check(bool(torch.allclose(got[4], got[3].sum(0),
                                      rtol=PHI_K_SUM_RTOL)),
                  f"{name} sweep: phi_k is not the sum of the phi rows "
                  f"{errors(got[4], got[3].sum(0))}")
            del got
            ms = cuda_time_ms(lambda: fn(*args, **vkw), 3)
            plain_ms = cuda_time_ms(lambda: ref(*args, **vkw), 1)
            lanes = (D_TRAIN * L_TRAIN * K_FULL if extra is None
                     else A_SCHED * live_tok)
            bound, by = _sweep_bound_ms(
                D_TRAIN, L_TRAIN, K_FULL, rows_used, live_tok, lanes,
                A_SCHED if extra is not None else 0, loglik)
            rec = {"variant": name + (" +loglik" if loglik else ""),
                   "kernel": fn.__name__, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by, "errors": errs}
            variants.append(rec)
            print("sweep kernel " + json.dumps(rec))
            torch.cuda.empty_cache()
    report["sweep_variants"] = variants
    del mu, theta, phi, ptot, post, args
    torch.cuda.empty_cache()


def training_phase(torch, store, report):
    """The training main path at the stream_1k width: FOEMTrainer on the
    card for three minibatches, one more step under the profiler, then a
    served batch from the trained store."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.trainer import FOEMTrainer
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.launch.serve import TopicServer, TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    cfg = lda_config(lda_shape("stream_1k"))
    t0 = time.perf_counter()
    gen = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                           seed=13)
    corpus = gen.corpus(4 * D_TRAIN)
    mbs = list(MinibatchStream(corpus, D_TRAIN, bucket_len=L_TRAIN, seed=0))
    corpus_s = time.perf_counter() - t0
    print(f"training corpus: {4 * D_TRAIN} documents, {len(mbs)} "
          f"minibatches of {D_TRAIN} x {L_TRAIN}, W_s "
          f"{[len(m.local_vocab) for m in mbs]}, made in {corpus_s:.1f} s")
    warm = max(1, cfg.warmup_sweeps)
    steps = []

    def record(m):
        rec = {"step": m.step, "sweeps": m.sweeps, "train_ppl": m.train_ppl,
               "residual_mass": m.residual_mass, "seconds": m.seconds,
               "fetch_s": m.fetch_seconds, "compute_s": m.compute_seconds,
               "writeback_s": m.writeback_seconds,
               "prefetch_hit": m.prefetch_hit}
        print("train step " + json.dumps(rec))
        steps.append(rec)
        check(warm <= m.sweeps <= cfg.max_sweeps,
              f"step {m.step} ran {m.sweeps} sweeps, not in "
              f"[{warm}, {cfg.max_sweeps}]")
        check(np.isfinite(m.train_ppl) and 1.0 < m.train_ppl < cfg.W,
              f"step {m.step} train perplexity {m.train_ppl} is not finite "
              "and in (1, W)")

    gs_sweep.launches = 0                 # counts of the main path only
    scheduled_sweep.launches = 0
    trainer = FOEMTrainer(cfg, store, seed=0, prefetch_depth=1,
                          device="cuda")
    t0 = time.perf_counter()
    trainer.fit_stream(iter(mbs[:3]), max_steps=3, callback=record)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"gs_sweep": gs_sweep.launches,
                "scheduled_sweep": scheduled_sweep.launches}
    check(len(steps) == 3, f"the trainer ran {len(steps)} of 3 steps")
    check(all(v > 0 for v in launches.values()),
          f"the training path did not launch both sweep kernels {launches}")
    print(f"training: 3 steps in {train_s:.1f} s, kernel calls "
          + json.dumps(launches))

    # one more step, synchronous, under the profiler
    torch.cuda.reset_peak_memory_stats()
    m, wall_ms, by_op, busy_ms = device_profile(
        torch, lambda: trainer.step(mbs[3]))
    record(m)
    groups = {}
    for name, v in by_op.items():
        key = ("sweep E-step" if "estep_kernel" in name else
               "sweep fold" if "fold_kernel" in name else
               "stop-rule loglik" if "loglik_kernel" in name else
               "memcpy HtoD" if "HtoD" in name else
               "memcpy DtoH" if "DtoH" in name else "other")
        groups[key] = groups.get(key, 0.0) + v
    profiled = {"wall_ms": wall_ms, "fetch_ms": m.fetch_seconds * 1e3,
                "compute_ms": m.compute_seconds * 1e3,
                "writeback_ms": m.writeback_seconds * 1e3,
                "sweeps": m.sweeps,
                "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                "device_busy_ms": busy_ms if by_op else None,
                "device_busy_share": busy_ms / wall_ms if by_op else None,
                "device_ms_by_group": groups,
                "device_ms_by_op": {k[:80]: v for k, v in
                                    list(by_op.items())[:12]}}
    print("profiled training step " + json.dumps(profiled) if by_op else
          "profiled training step: device time not measured "
          "(no device events)")

    # train, then serve: the trained store answers a held-out batch
    w, est, ev = report["heldout"]
    _, ppl = TopicServer(store, cfg, device="cuda").evaluate(w, est, ev)
    check(np.isfinite(ppl) and 1.0 < ppl < cfg.W,
          f"eq. 21 perplexity {ppl} of the trained store is not finite "
          "and in (1, W)")
    print(f"served from the trained store: eq. 21 perplexity {ppl}")
    report["training"] = {"steps": steps, "train_s": train_s,
                          "corpus_s": corpus_s, "launches": launches,
                          "profiled": profiled, "served_ppl": ppl}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False    # plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          + json.dumps(built))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    report = {}
    t_start = time.perf_counter()
    kernel_phase(torch, dev, report)
    store_dir = ROOT / "build" / "chip_smoke_store"
    try:
        store, gen = make_store(store_dir, report)
        serving_phase(torch, store, gen, report)
        sweep_kernel_phase(torch, dev, store, report)
        training_phase(torch, store, report)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    print(f"phases took {time.perf_counter() - t_start:.1f} s")

    f32 = report["variants"][0]
    max_err = max(e["max_abs"] for v in report["variants"]
                  for e in v["errors"].values())
    entries = [{
        "name": "theta_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/theta_sweep.cu",
        "replaces": "src/repro/kernels/theta_sweep.py:262",
        "launches": report["serving"]["launches"],
        "max_abs_err": max_err,
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
    }]
    for name, source, replaces in (
            ("gs_sweep", "src/repro_torch/kernels/csrc/gs_sweep.cu",
             "src/repro/kernels/gs_sweep.py:231"),
            ("scheduled_sweep",
             "src/repro_torch/kernels/csrc/scheduled_sweep.cu",
             "src/repro/kernels/scheduled_sweep.py:178")):
        mine = [v for v in report["sweep_variants"] if v["kernel"] == name]
        base = mine[0]                     # the call without the stop rule
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": report["training"]["launches"][name],
            # μ_new, the sweep's per-token output (all outputs are in the
            # "sweep kernel" lines)
            "max_abs_err": max(v["errors"]["mu"]["max_abs"] for v in mine),
            "ms": base["ms"],
            "plain_ms": base["plain_ms"],
            "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"],
            "library_ms": None,
        })
    kernels = {"kernels": entries}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
