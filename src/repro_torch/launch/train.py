"""Training entry point (PyTorch port of ``repro.launch.train``).  Two modes:

* ``--arch foem-lda`` (the default) — the paper's system: streaming FOEM
  (or SEM) with the disk-backed ParameterStore.
* ``--arch <lm-arch>`` (an LM of ``configs.registry.ARCHS``: dense, MoE
  or SSM) — the arch's ``.reduced()`` config trained on synthetic token
  streams (``train_lm``): AdamW, a cosine schedule with warmup, checkpoints every
  ``--ckpt-every`` steps and ``--resume`` from the latest one.

In LDA mode it trains on a synthetic LDA corpus
(``data.synthetic_lda_corpus``, drawn from ``--topics-true`` topics, by
default ``--topics``), one ``FOEMTrainer`` step per minibatch (a line every
``--log-every`` steps), then reports the eq. 21 held-out predictive
perplexity of the trained store on a 10% test split.  The store in
``--workdir`` flushes every ``--ckpt-every`` steps; ``--resume`` continues
from its minibatch cursor.  Run on a GPU host with

    PYTHONPATH=src python -m repro_torch.launch.train --workdir DIR \\
        --steps 4 --topics 64 --vocab 3000 [--iem-blocks 4] [--algorithm sem]

or on the host's CPU with ``--device cpu``.  Without ``--device cpu`` on a
host with no GPU it exits with "no CUDA device".  LM mode:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --workdir DIR --steps 12 --ckpt-every 5 [--resume] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.foem_lda import NAME as LDA_ARCH
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


def lm_train_step(model, params, opt, batch, *, total_steps: int):
    """One step of ``train_lm`` on injected parameters and optimizer state:
    ``loss.backward()`` through ``model.loss_fn``, the learning rate
    ``cosine_warmup(opt.count, peak_lr=1e-3, warmup=20, total=total_steps)``
    from the count BEFORE its increment (so step 1 runs at lr 0), then
    ``adamw_update`` in place.  The parameters are leaf tensors that require
    grad; their ``.grad`` is cleared after the update.  Returns ``(loss,
    params, opt)``, the loss a detached 0-d float32 tensor."""
    from repro_torch.checkpoint.ckpt import tree_flatten, tree_unflatten
    from repro_torch.optim import adamw_update, cosine_warmup

    loss = model.loss_fn(params, batch)
    loss.backward()
    leaves = tree_flatten(params)[0]
    grads = tree_unflatten(params, [p.grad for p in leaves])
    lr = cosine_warmup(opt.count, peak_lr=1e-3, warmup=20, total=total_steps)
    params, opt = adamw_update(grads, opt, params, lr=lr)
    for p in leaves:
        p.grad = None
    return loss.detach(), params, opt


def lm_batch(cfg, batch: Dict[str, torch.Tensor]) -> Dict[str,
                                                         torch.Tensor]:
    """A token batch of ``synthetic_token_stream`` in ``cfg``'s inputs, as
    the JAX package's ``train_lm`` builds them: an audio config's
    ``embeds`` = one_hot(tokens mod d_model) float32 in place of
    ``tokens``; a VLM's ``image_embeds`` of ones × 0.01, (B, image_tokens,
    d_model) float32, beside them."""
    batch = dict(batch)
    if cfg.frontend == "audio_frames":
        batch["embeds"] = torch.nn.functional.one_hot(
            batch.pop("tokens").long() % cfg.d_model, cfg.d_model).float()
    if cfg.frontend == "image_patches":
        B = batch["labels"].shape[0]
        batch["image_embeds"] = torch.ones(
            (B, cfg.image_tokens, cfg.d_model), dtype=torch.float32) * 0.01
    return batch


def train_lm(args) -> List[float]:
    """The ``--arch <lm-arch>`` CLI: train the reduced config from random
    weights (a ``torch.Generator`` seeded with ``--seed`` on the device),
    or resume from the workdir's latest checkpoint of (params, opt state);
    returns the logged losses."""
    from repro_torch.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.checkpoint.ckpt import tree_map
    from repro_torch.configs.registry import ARCHS   # the LM stack
    from repro_torch.data.synthetic import synthetic_token_stream
    from repro_torch.models import build
    from repro_torch.optim import adamw_init

    if args.arch not in ARCHS:
        raise SystemExit(f"unknown arch {args.arch!r}: {LDA_ARCH} or one of "
                         f"{sorted(ARCHS)}")
    cfg = ARCHS[args.arch].reduced()
    model = build(cfg, device=args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(args.seed))
    opt = adamw_init(params)
    step0 = 0
    os.makedirs(args.workdir, exist_ok=True)
    if args.resume and latest_step(args.workdir) is not None:
        step0, host = restore_checkpoint(args.workdir, (params, opt))
        params, opt = tree_map(
            lambda a, like: torch.from_numpy(np.asarray(a)).to(like.device),
            host, (params, opt))
        print(f"[resume] from step {step0}")
    tree_map(lambda p: p.requires_grad_(), params)

    stream = synthetic_token_stream(args.minibatch, args.seq_len,
                                    cfg.vocab_size, seed=args.seed + step0)
    t0 = time.time()
    losses = []
    for step in range(step0 + 1, args.steps + 1):
        batch = lm_batch(cfg, {k: torch.from_numpy(v)
                               for k, v in next(stream).items()})
        loss, params, opt = lm_train_step(model, params, opt, batch,
                                          total_steps=args.steps)
        if step % args.log_every == 0:
            losses.append(float(loss))
            print(f"step {step:5d} loss={losses[-1]:8.4f} "
                  f"({(time.time() - t0) / step:.2f}s/step)", flush=True)
        if args.ckpt_every and step % args.ckpt_every == 0:
            save_checkpoint(args.workdir, step, (params, opt))
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s")
    return losses


def main(argv: Optional[Sequence[str]] = None):
    """The CLI: LDA mode returns the eq. 21 held-out perplexity, LM mode
    the logged losses."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=LDA_ARCH,
                    help=f"{LDA_ARCH} (default) or an LM arch (granite-8b, "
                         "granite-20b, internlm2-20b, h2o-danube-3-4b, "
                         "qwen2-moe-a2.7b, qwen3-moe-235b-a22b, "
                         "mamba2-370m, jamba-1.5-large-398b, "
                         "llama-3.2-vision-11b, musicgen-medium), trained "
                         "at its reduced config")
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
    ap.add_argument("--seq-len", type=int, default=128,
                    help="tokens a sequence (LM mode)")
    args = ap.parse_args(argv)
    if args.arch == LDA_ARCH:
        return train_lda(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
