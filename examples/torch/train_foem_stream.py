"""End-to-end run of the PyTorch port: lifelong FOEM training with the
full system stack — streaming minibatches, dynamic scheduling, disk-backed
parameter streaming, periodic checkpointing, crash recovery and held-out
evaluation (``repro_torch.launch.train``).

~100M-parameter regime (K x W = 1000 x 20000 = 2·10^7 stats by default).

    PYTHONPATH=src python examples/torch/train_foem_stream.py --steps 40
    # kill it mid-run, then resume:
    PYTHONPATH=src python examples/torch/train_foem_stream.py --steps 40 \\
        --resume
    PYTHONPATH=src python examples/torch/train_foem_stream.py --quick \\
        --device cpu
"""
import argparse

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--topics", type=int, default=1000)
    ap.add_argument("--vocab", type=int, default=20000)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--workdir", default="build/examples/foem_stream")
    ap.add_argument("--prefetch-depth", type=int, default=1,
                    help="φ̂-row prefetch pipeline depth (0 = synchronous)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="a small cell: 3 steps, 32 topics over 1,000 "
                         "words, 300 documents")
    args = ap.parse_args(argv)
    steps, topics, vocab, docs = (args.steps, args.topics, args.vocab, 3000)
    if args.quick:
        steps, topics, vocab, docs = 3, 32, 1000, 300
    argv = [
        "--workdir", args.workdir,
        "--steps", str(steps),
        "--topics", str(topics),
        "--vocab", str(vocab),
        "--docs", str(docs),
        "--doc-len", "64",
        "--minibatch", "256" if not args.quick else "64",
        "--active-topics", "10",
        "--max-sweeps", "12",
        "--buffer-rows", "4096",
        "--prefetch-depth", str(args.prefetch_depth),
        "--ckpt-every", "5",
        "--topics-true", "32" if not args.quick else "8",
        "--device", args.device,
    ]
    if args.resume:
        argv.append("--resume")
    return train.main(argv)


if __name__ == "__main__":
    main()
