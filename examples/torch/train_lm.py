"""Train a reduced-config LM of the PyTorch port on synthetic token
streams — the LM substrate end to end (AdamW, checkpoints, resume) through
``repro_torch.launch.train --arch``.

    PYTHONPATH=src python examples/torch/train_lm.py --arch granite-8b \\
        --steps 30
    # the VLM, the audio LM and the hybrid stack the same way:
    PYTHONPATH=src python examples/torch/train_lm.py \\
        --arch llama-3.2-vision-11b   # musicgen-medium, jamba-1.5-large-398b
    # resume from the latest checkpoint:
    PYTHONPATH=src python examples/torch/train_lm.py --steps 40 --resume
    PYTHONPATH=src python examples/torch/train_lm.py --quick --device cpu
"""
import argparse

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b",
                    help="granite-8b, granite-20b, internlm2-20b, "
                         "h2o-danube-3-4b, qwen2-moe-a2.7b, "
                         "qwen3-moe-235b-a22b, mamba2-370m, "
                         "jamba-1.5-large-398b, llama-3.2-vision-11b or "
                         "musicgen-medium (trained at its reduced config)")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint directory (default "
                         "build/examples/lm_<arch>)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="6 steps, a checkpoint every 3")
    args = ap.parse_args(argv)
    steps, ckpt, log = args.steps, 10, 5
    if args.quick:
        steps, ckpt, log = 6, 3, 1
    argv = [
        "--arch", args.arch,
        "--workdir", args.workdir or f"build/examples/lm_{args.arch}",
        "--steps", str(steps),
        "--minibatch", "8",
        "--seq-len", "64",
        "--ckpt-every", str(ckpt),
        "--log-every", str(log),
        "--device", args.device,
    ]
    if args.resume:
        argv.append("--resume")
    return train.main(argv)


if __name__ == "__main__":
    main()
