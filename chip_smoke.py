#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
with ``nvcc``, holds each kernel against its plain PyTorch version on the
card at the serving path's shapes (K = 10,000 topics, 256 documents of
64–256 tokens), then drives the serving path — ``TopicServer`` over a
disk-backed ``ParameterStore`` at the ``stream_1k`` width (capacity W =
141,043 rows × K = 10,000, 5.6 GB of float32 written to ``build/``, deleted
at the end) — and checks the answers.  One warm batch runs under
``torch.profiler``, which prints its device time by operation and the
card's busy share of the batch's wall time.  Any failed check exits non-zero
before the result lines.  The last two lines of standard output are a
``{"kernels": [...]}`` JSON object and the device record
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no result.
It imports nothing of JAX or of the JAX package.
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


def serving_phase(torch, report):
    """The serving main path at the stream_1k width."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.perplexity import split_heldout_counts
    from repro_torch.core.streaming import store_from_arrays
    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.kernels.theta_sweep import theta_sweep
    from repro_torch.launch.serve import TopicServer, TrafficGenerator
    from repro_torch.sparse import bucketize

    store_dir = ROOT / "build" / "chip_smoke_store"
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
    try:
        gen = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN, seed=7)
        t0 = time.perf_counter()
        store = store_from_arrays(
            str(store_dir), trained_like_phi_blocks(
                cap, K_FULL, ranks=gen.word_ranks(), seed=0),
            live_vocab=cap, vocab_capacity=cap)
        write_s = time.perf_counter() - t0
        print(f"store written: {cap} x {K_FULL} float32 "
              f"({cap * K_FULL * 4 / 1e9:.2f} GB) in {write_s:.1f} s")
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
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    lat_ms = [x * 1e3 for x in lat]
    rec = {"batch_docs": B, "batch_ms": lat_ms,
           "fetch_ms": [x * 1e3 for x in fetch],
           "fit_ms": [x * 1e3 for x in fit], "sweeps": sweeps,
           "docs_per_s": B * len(lat) / sum(lat),
           "eq21_ppl_f32": ppl, "eq21_ppl_int8": ppl_q,
           "int8_drift": ppl_q / ppl - 1.0, "hot_cache_hit_rate": hit_rate,
           "store_write_s": write_s, "launches": launches}
    print("serving " + json.dumps(rec))
    report["serving"] = rec


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
    kernel_phase(torch, dev, report)
    serving_phase(torch, report)

    f32 = report["variants"][0]
    max_err = max(e["max_abs"] for v in report["variants"]
                  for e in v["errors"].values())
    kernels = {"kernels": [{
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
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
