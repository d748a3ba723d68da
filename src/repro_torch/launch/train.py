"""Training driver — streaming FOEM (or SEM) with the disk-backed
ParameterStore (PyTorch port of the LDA half of ``repro.launch.train``).

Trains on a synthetic LDA corpus (``data.synthetic_lda_corpus``, drawn
from ``--topics-true`` topics, by default ``--topics``), one
``FOEMTrainer`` step per minibatch (a line every ``--log-every`` steps),
then reports the eq. 21 held-out predictive perplexity of the trained
store on a 10% test split.  The store
in ``--workdir`` flushes every ``--ckpt-every`` steps; ``--resume`` continues
from its minibatch cursor.  Run on a GPU host with

    PYTHONPATH=src python -m repro_torch.launch.train --workdir DIR \\
        --steps 4 --topics 64 --vocab 3000 [--iem-blocks 4] [--algorithm sem]

or on the host's CPU with ``--device cpu``.  Without ``--device cpu`` on a
host with no GPU it exits with "no CUDA device".
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.perplexity import predictive_perplexity, split_heldout_counts
from repro_torch.core.streaming import ParameterStore
from repro_torch.core.trainer import FOEMTrainer, StepMetrics
from repro_torch.core.types import LDAConfig, MinibatchData
from repro_torch.data.synthetic import synthetic_lda_corpus
from repro_torch.runtime.device import resolve_device
from repro_torch.sparse.docword import bucketize
from repro_torch.sparse.minibatch import MinibatchStream


def train_lda(args) -> float:
    """Train, then return the eq. 21 held-out perplexity."""
    dev = resolve_device(args.device)
    cfg = LDAConfig(
        num_topics=args.topics,
        vocab_size=args.vocab,
        active_topics=args.active_topics,
        max_sweeps=args.max_sweeps,
        iem_blocks=args.iem_blocks,
    )
    corpus, _ = synthetic_lda_corpus(
        args.docs, args.vocab, args.topics_true or args.topics,
        mean_doc_len=args.doc_len, seed=args.seed,
    )
    rng = np.random.default_rng(args.seed)
    train, test = corpus.split_train_test(max(args.docs // 10, 8), rng)
    os.makedirs(args.workdir, exist_ok=True)
    store = ParameterStore(
        args.workdir, num_topics=args.topics, vocab_capacity=args.vocab,
        buffer_rows=args.buffer_rows,
    )
    trainer = FOEMTrainer(
        cfg, store, seed=args.seed, checkpoint_every=args.ckpt_every,
        algorithm=args.algorithm, prefetch_depth=args.prefetch_depth,
        device=dev,
    )
    start = trainer.resume_step() if args.resume else 0
    if start:
        print(f"[resume] continuing from minibatch cursor {start}")
    stream = MinibatchStream(
        train, args.minibatch, seed=args.seed + start, epochs=None
    )
    t0 = time.time()

    def report(m: StepMetrics) -> None:
        if m.step % args.log_every:
            return
        pf = "+" if m.prefetch_hit else "-"
        print(
            f"step {m.step:5d} sweeps={m.sweeps:2d} "
            f"train_ppl={m.train_ppl:9.2f} io r/w={m.disk_reads}/"
            f"{m.disk_writes} hits={m.buffer_hits} pf{pf} "
            f"fetch/compute/write={m.fetch_seconds * 1e3:.1f}/"
            f"{m.compute_seconds * 1e3:.1f}/{m.writeback_seconds * 1e3:.1f}ms "
            f"{m.seconds:5.2f}s", flush=True,
        )

    trainer.fit_stream(iter(stream), max_steps=args.steps, callback=report)
    print(f"trained {args.steps} minibatches in {time.time() - t0:.1f}s")

    # held-out predictive perplexity (paper eq. 21)
    w, c = bucketize(test, list(range(test.num_docs)))
    est_c, ev_c = split_heldout_counts(c, rng)
    phi = store.dense_phi()
    pad = cfg.W - phi.shape[0]
    if pad > 0:
        phi = np.pad(phi, ((0, pad), (0, 0)))
    ppl = float(predictive_perplexity(
        args.seed, MinibatchData(w, est_c), MinibatchData(w, ev_c),
        phi, store.phi_k.astype(np.float32), cfg, device=dev,
    ))
    print(f"predictive perplexity (eq. 21): {ppl:.2f}")
    return ppl


def main(argv: Optional[Sequence[str]] = None) -> float:
    """The CLI: train, then return the eq. 21 held-out perplexity."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="build/repro_torch_train")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=1,
                    help="print every N-th step's line")
    ap.add_argument("--algorithm", default="foem", choices=["foem", "sem"])
    ap.add_argument("--topics", type=int, default=100)
    ap.add_argument("--topics-true", type=int, default=0,
                    help="topics of the synthetic corpus's generating model "
                         "(0 = --topics)")
    ap.add_argument("--vocab", type=int, default=5000)
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--doc-len", type=int, default=80)
    ap.add_argument("--minibatch", type=int, default=256)
    ap.add_argument("--active-topics", type=int, default=16)
    ap.add_argument("--max-sweeps", type=int, default=24)
    ap.add_argument("--iem-blocks", type=int, default=0,
                    help="0 = column-serial IEM folds (paper-faithful)")
    ap.add_argument("--buffer-rows", type=int, default=2048)
    ap.add_argument("--prefetch-depth", type=int, default=1,
                    help="minibatches fetched ahead of the device "
                         "(0 = synchronous host I/O)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return train_lda(args)


if __name__ == "__main__":
    main()
