"""Time the plain stream_1k ``FOEMTrainer.step`` of one source tree.

    python3 time_train_step.py --src SRC --store DIR [--steps 3]

imports ``repro_torch`` from ``SRC`` (a checkout's ``src/``, so that two
trees, say a parent and a change, run the same script), writes the
stream_1k store under ``DIR`` afresh from a seed, as ``chip_smoke.py``
makes it (141,043 × 10,000 trained-like rows), so that every run starts
from the same state, and runs ``FOEMTrainer.step`` with ``debug_checks``
off on the first ``1 + steps`` 1,024 × 128 minibatches of the training
phase's corpus: the first builds and warms the kernels, the rest are
timed.  Prints one JSON line: the tree, the card's name and power limit,
and per timed step its wall seconds (synced), the trainer's compute
seconds and its sweeps.  Needs one CUDA card and builds the kernels of
``SRC``.  To compare two trees, alternate them within one machine's run:
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

D_TRAIN, L_TRAIN = 1024, 128        # chip_smoke.py's stream_1k minibatch
DOC_LEN = (64, 256)                 # its tokens per document


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.streaming import store_from_arrays
    from repro_torch.core.trainer import FOEMTrainer
    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = lda_config(lda_shape("stream_1k"))
    shutil.rmtree(args.store, ignore_errors=True)
    Path(args.store).parent.mkdir(parents=True, exist_ok=True)
    gen = TrafficGenerator(vocab_size=cfg.W, doc_len=DOC_LEN, seed=7)
    store = store_from_arrays(
        args.store, trained_like_phi_blocks(cfg.W, cfg.K,
                                            ranks=gen.word_ranks(), seed=0),
        live_vocab=cfg.W, vocab_capacity=cfg.W)
    corpus = TrafficGenerator(vocab_size=cfg.W, doc_len=DOC_LEN,
                              seed=13).corpus(D_TRAIN * (1 + args.steps))
    mbs = list(MinibatchStream(corpus, D_TRAIN, bucket_len=L_TRAIN, seed=0))
    trainer = FOEMTrainer(cfg, store, seed=0, prefetch_depth=0,
                          device="cuda")
    steps = []
    for i, mb in enumerate(mbs[:1 + args.steps]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(mb)
        torch.cuda.synchronize()
        if i:
            steps.append({"wall_s": time.perf_counter() - t0,
                          "compute_s": m.compute_seconds,
                          "sweeps": m.sweeps, "train_ppl": m.train_ppl})
    print(json.dumps({"src": str(src), "card": card, "steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
