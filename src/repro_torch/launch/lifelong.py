"""Lifelong train-while-serve entry point — the paper's headline scenario
(PyTorch port of ``repro.launch.lifelong``).

One ``FOEMTrainer`` and one ``TopicServer`` + ``ServingEngine`` run
concurrently against the same ``ParameterStore``, connected only by the
versioned snapshot publish/subscribe protocol::

      trainer thread                         serving side
      ──────────────                         ────────────
      fit_stream(endless minibatches)        ServingEngine launcher
        step → write_rows → ...                │ refresh(): hot-swap to the
        every `publish_every` steps:           │ newest committed version
          SnapshotPublisher.publish()          │ (between launches; in-flight
          │  WAL flush (COMMIT) under          │ batches finish on their
          │  the store lock, immutable         │ pinned epoch)
          │  crc-manifested PhiSnapshot        │
          ▼                                    ▼
        ShiftDetector.update(residual         every θ resolves as a
        mass, train ppl, φ_k shares)          ThetaResult tagged with its
        → scheduler refresh / topic           committed snapshot version
        birth-death events in StepMetrics

Serving reads a φ at most ``retain`` committed versions behind the trainer,
and the trainer's trajectory is untouched by serving (snapshot reads only:
training is bitwise identical with or without traffic).  On the card the
trainer thread and the engine's launcher both launch kernels on the
device's default stream, so their kernels run one after another.

:func:`run_lifelong` builds a small synthetic scenario and runs it;
:func:`serve_while_training` is the scenario itself, for callers that build
the trainer, publisher, detector and server themselves (at widths whose
synthetic corpus would not fit in memory).  Run on a GPU host with

    PYTHONPATH=src python -m repro_torch.launch.lifelong --quick

or on the host's CPU with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (
    FOEMTrainer,
    LDAConfig,
    ParameterStore,
    ShiftDetector,
    SnapshotPublisher,
)
from repro_torch.core.perplexity import split_heldout_counts
from repro_torch.data.synthetic import synthetic_lda_corpus
from repro_torch.launch.serve import (
    ServingEngine,
    TopicServer,
    TrafficGenerator,
)
from repro_torch.runtime.device import Device, resolve_device
from repro_torch.sparse.docword import bucketize
from repro_torch.sparse.minibatch import Minibatch, MinibatchStream

#: Seconds to wait for one request's θ, and for the trainer thread to end.
TIMEOUT_S = 300.0


def serve_while_training(
    trainer: FOEMTrainer,
    publisher: SnapshotPublisher,
    detector: ShiftDetector,
    server: TopicServer,
    stream: Iterator[Minibatch],
    trace: Sequence[Tuple[float, np.ndarray, np.ndarray]],
    *,
    steps: int,
    heldout: Tuple[np.ndarray, np.ndarray, np.ndarray],
    max_batch: int = 32,
    max_delay_ms: float = 5.0,
    max_len: int = 48,
    pace: bool = False,
    prewarm: bool = True,
    wave_gap_s: float = 0.05,
    seed: int = 0,
    record: Optional[dict] = None,
) -> dict:
    """Train ``steps`` minibatches of ``stream`` while serving ``trace``,
    and return the report.

    ``server`` must already be subscribed to ``publisher``, which must
    hold a committed version.  The first step runs before traffic opens;
    the other ``steps − 1`` run in a trainer thread (under
    ``torch.cuda.device`` of the trainer's device) while a
    ``ServingEngine`` over ``server`` replays ``trace`` in waves — paced by
    its arrival times or back to back — until the trainer finishes.  Then
    the server swaps to the final publish and scores ``heldout = (word_ids,
    est_counts, ev_counts)`` with eq. 21 on it.  Every future and the
    trainer thread are waited for at most ``TIMEOUT_S``.

    The report has the JAX package's keys: publish and swap logs, the
    observed staleness bound, per-request latency percentiles, failed and
    uncommitted-version counts, shift events, the held-out perplexity.
    ``recompiled`` is always False: the port compiles nothing per shape.
    ``record``, when given, receives the engine's ``batch_log``, its
    ``metrics``, every resolved θ (``thetas``, in submission order) and
    the seconds from the first submit to the last result
    (``traffic_seconds``).
    """
    train_errors: List[BaseException] = []
    # step 1 runs before traffic opens, so the serving window overlaps the
    # trainer's steps (and their publishes)
    trainer.step(next(stream))
    dev = trainer.device

    def train_loop() -> None:
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                trainer.fit_stream(stream, max_steps=max(steps - 1, 0))
        except BaseException as e:  # re-raised after the join, never silent
            train_errors.append(e)

    t_start = time.perf_counter()
    failed = 0
    served_versions: List[int] = []
    thetas: List[np.ndarray] = []
    with ServingEngine(server, max_batch=max_batch,
                       max_delay_ms=max_delay_ms,
                       max_len=max_len, seed=seed) as eng:
        if prewarm:
            eng.prewarm()
        th = threading.Thread(target=train_loop, name="lifelong-trainer")
        th.start()
        # traffic must SPAN the publishes: keep replaying the trace in
        # waves until the trainer finishes, so the latency percentiles
        # cover hot-swaps, not just the first version
        n_submitted = 0
        waves = 0
        t_traffic = time.perf_counter()
        while True:
            futs = TrafficGenerator.replay(trace, eng.submit, pace=pace)
            n_submitted += len(futs)
            for f in futs:
                try:
                    theta = f.result(timeout=TIMEOUT_S)
                    served_versions.append(int(getattr(theta, "version", -1)))
                    thetas.append(theta)
                except Exception:
                    failed += 1
            waves += 1
            # the trainer ends after `steps` steps, so this loop does too;
            # the cap is a backstop against a wedged trainer thread
            if not th.is_alive() or waves >= 1000:
                break
            # yield between waves: an unthrottled closed loop starves the
            # trainer thread of the GIL
            time.sleep(wave_gap_s)
        traffic_seconds = time.perf_counter() - t_traffic
        th.join(timeout=TIMEOUT_S)
        if th.is_alive():
            raise RuntimeError(
                f"the trainer thread did not finish within {TIMEOUT_S} s")
        server.refresh()                 # pick up the final publish
        eng.drain()
        m = eng.metrics()
        batch_log = list(eng.batch_log)
    if train_errors:
        raise train_errors[0]

    committed = {rec["version"] for rec in publisher.publish_log}
    uncommitted = sorted(set(served_versions) - committed)
    stale = [
        b["published_version"] - b["version"]
        for b in batch_log
        if b.get("version", -1) >= 0 and b.get("published_version", -1) >= 0
    ]

    # held-out perplexity on the final served version (eq. 21): θ̂ fit on
    # the estimate counts, the evaluation counts scored in the same launch
    w, est, ev = heldout
    _, heldout_ppl = server.evaluate(w, est, ev)

    if record is not None:
        record.update(batch_log=batch_log, metrics=m, thetas=thetas,
                      traffic_seconds=traffic_seconds)
    return {
        "steps": steps,
        "train_steps": len(trainer.history),
        "publishes": len(publisher.publish_log),
        "publish_log": publisher.publish_log,
        "swap_log": server.swap_log,
        "swap_seconds_max": (
            max(s["seconds"] for s in server.swap_log)
            if server.swap_log else 0.0
        ),
        "staleness_versions_max": int(max(stale)) if stale else 0,
        "requests": n_submitted,
        "traffic_waves": waves,
        "failed_requests": failed,
        "uncommitted_versions": uncommitted,
        "served_version_min": min(served_versions) if served_versions else -1,
        "served_version_max": max(served_versions) if served_versions else -1,
        "p50_ms": m.get("p50_ms", 0.0),
        "p99_ms": m.get("p99_ms", 0.0),
        "mean_fill": m.get("mean_fill", 0.0),
        "recompiled": False,
        "heldout_ppl": float(heldout_ppl),
        "shift_events": [dataclasses.asdict(e) for e in detector.events],
        "wall_seconds": time.perf_counter() - t_start,
    }


def run_lifelong(
    *,
    workdir: str,
    topics: int = 32,
    vocab: int = 2048,
    docs: int = 512,
    minibatch: int = 64,
    steps: int = 12,
    publish_every: int = 4,
    retain: int = 2,
    requests: int = 128,
    qps: float = 200.0,
    pace: bool = False,
    doc_len: Tuple[int, int] = (8, 48),
    max_batch: int = 32,
    max_delay_ms: float = 5.0,
    fit_sweeps: int = 20,
    hot_rows: int = 256,
    phi_dtype: str = "float32",
    buffer_rows: int = 0,
    seed: int = 0,
    prewarm: bool = True,
    wave_gap_s: float = 0.05,
    device: Device = "cuda",
) -> dict:
    """Run the end-to-end lifelong scenario on a synthetic LDA corpus and
    return its report (:func:`serve_while_training`).

    The trainer consumes an endless minibatch stream and publishes a
    committed snapshot every ``publish_every`` steps (version 1 before any
    traffic); the engine replays a Zipf/Poisson trace against whichever
    version is newest at each launch.  ``device`` (default ``"cuda"``,
    which raises without a GPU) runs both the trainer and the server.
    """
    dev = resolve_device(device)
    cfg = LDAConfig(num_topics=topics, vocab_size=vocab,
                    max_sweeps=fit_sweeps)
    corpus, _ = synthetic_lda_corpus(
        docs, vocab, topics, mean_doc_len=max(doc_len), seed=seed
    )
    store = ParameterStore(workdir, num_topics=topics,
                           vocab_capacity=vocab + 256,
                           buffer_rows=buffer_rows)
    publisher = SnapshotPublisher(store, retain=retain)
    detector = ShiftDetector()
    trainer = FOEMTrainer(
        cfg, store, seed=seed,
        publisher=publisher, publish_every=publish_every,
        shift_detector=detector, device=dev,
    )
    # version 1 before any traffic: the server always has a committed φ to
    # pin, even before the first cadence publish
    publisher.publish()

    server = TopicServer(store, cfg, fit_sweeps=fit_sweeps, rel_tol=0.0,
                         check_every=max(fit_sweeps, 1),
                         vocab_pad=max(256, min(vocab, 1024)),
                         phi_dtype=phi_dtype, hot_rows=hot_rows, device=dev)
    server.subscribe(publisher)

    gen = TrafficGenerator(vocab, doc_len=doc_len, seed=seed + 1)
    trace = gen.trace([(qps, requests)])
    stream = iter(MinibatchStream(corpus, minibatch, seed=seed, epochs=None))

    ev_rng = np.random.default_rng(seed + 2)
    n_ev = min(64, corpus.num_docs)
    w, c = bucketize(corpus, list(range(n_ev)), pad_multiple=16)
    est, ev = split_heldout_counts(c, ev_rng)
    return serve_while_training(
        trainer, publisher, detector, server, stream, trace,
        steps=steps, heldout=(w, est, ev), max_batch=max_batch,
        max_delay_ms=max_delay_ms,
        max_len=int(np.ceil(max(doc_len) / 16) * 16), pace=pace,
        prewarm=prewarm, wave_gap_s=wave_gap_s, seed=seed,
    )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="build/repro_torch_lifelong")
    ap.add_argument("--topics", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--docs", type=int, default=512)
    ap.add_argument("--minibatch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--publish-every", type=int, default=4)
    ap.add_argument("--retain", type=int, default=2)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--pace", action="store_true",
                    help="honour trace arrival timestamps")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--fit-sweeps", type=int, default=20)
    ap.add_argument("--hot-rows", type=int, default=256)
    ap.add_argument("--phi-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--buffer-rows", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="tiny smoke cell instead of the defaults")
    args = ap.parse_args(argv)
    kw = dict(
        workdir=args.workdir, topics=args.topics, vocab=args.vocab,
        docs=args.docs, minibatch=args.minibatch, steps=args.steps,
        publish_every=args.publish_every, retain=args.retain,
        requests=args.requests, qps=args.qps, pace=args.pace,
        max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
        fit_sweeps=args.fit_sweeps, hot_rows=args.hot_rows,
        phi_dtype=args.phi_dtype, buffer_rows=args.buffer_rows,
        seed=args.seed, device=args.device,
    )
    if args.quick:
        # the JAX package's quick cell
        kw.update(topics=16, vocab=512, docs=128, minibatch=128, steps=6,
                  publish_every=2, requests=48, doc_len=(8, 24),
                  max_batch=16, fit_sweeps=10, hot_rows=64)
    report = run_lifelong(**kw)
    print(f"lifelong: {report['train_steps']} train steps, "
          f"{report['publishes']} publishes, "
          f"{report['requests']} requests "
          f"({report['failed_requests']} failed)")
    print(f"  served versions v{report['served_version_min']}"
          f"..v{report['served_version_max']} "
          f"(staleness ≤ {report['staleness_versions_max']} versions, "
          f"uncommitted: {report['uncommitted_versions'] or 'none'})")
    print(f"  swap ≤ {report['swap_seconds_max']*1e3:.2f}ms  "
          f"p50 {report['p50_ms']:.1f}ms  p99 {report['p99_ms']:.1f}ms  "
          f"held-out ppl {report['heldout_ppl']:.1f}")
    if report["shift_events"]:
        kinds = [e["kind"] for e in report["shift_events"]]
        print(f"  shift events: {kinds}")
    return report


if __name__ == "__main__":
    main()
