"""Quickstart: train FOEM-LDA on a synthetic corpus with the PyTorch port.

    PYTHONPATH=src python examples/torch/quickstart.py             # the GPU
    PYTHONPATH=src python examples/torch/quickstart.py --quick --device cpu

Each minibatch is one ``foem.foem_step`` with ``iem_blocks=4``: blocked
E-steps (the ``fused_estep`` kernel on the card) and, after the warm-up,
the blocked scheduled sweep (the ``topk_estep`` block loop).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import GlobalStats, LDAConfig, MinibatchData, foem
from repro_torch.core.em import normalize_phi
from repro_torch.data import synthetic_lda_corpus
from repro_torch.runtime.device import resolve_device
from repro_torch.sparse import MinibatchStream


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="4 minibatches instead of 12")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    K, W = 12, 600
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=16,
                    active_topics=6, iem_blocks=4)
    corpus, _ = synthetic_lda_corpus(400, W, K, mean_doc_len=70, seed=0)

    stats = GlobalStats.zeros(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ppls = []
    for i, mb in enumerate(MinibatchStream(corpus, 64, seed=0, epochs=3)):
        if i >= (4 if args.quick else 12):
            break
        batch = MinibatchData(torch.from_numpy(mb.word_ids),
                              torch.from_numpy(mb.counts))
        stats, _, diag = foem.foem_step(gen, batch, stats, cfg, device=dev)
        ppls.append(float(diag.final_train_ppl))
        print(f"minibatch {i:2d}: inner sweeps={int(diag.sweeps_run):3d} "
              f"train ppl={ppls[-1]:8.2f}")

    phi = normalize_phi(stats.phi_wk, stats.phi_k, cfg).cpu().numpy()
    print("\ntop words per topic (ids):")
    for k in range(K):
        top = np.argsort(-phi[:, k])[:8]
        print(f"  topic {k:2d}: {top.tolist()}")
    return ppls


if __name__ == "__main__":
    main()
