"""Lifelong train-while-serve with the PyTorch port: one FOEMTrainer
publishing versioned φ snapshots while a ServingEngine serves topic
mixtures against them — zero-downtime hot-swaps, every response tagged
with its committed snapshot version (``repro_torch.launch.lifelong``).

    PYTHONPATH=src python examples/torch/lifelong_serve.py          # full demo
    PYTHONPATH=src python examples/torch/lifelong_serve.py --quick --device cpu
"""
import argparse

from repro_torch.launch import lifelong


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the lifelong CLI's tiny smoke cell")
    ap.add_argument("--workdir", default=None,
                    help="store directory (default build/examples/"
                         "lifelong_smoke or lifelong_demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        argv = ["--quick",
                "--workdir", args.workdir or "build/examples/lifelong_smoke"]
    else:
        argv = [
            "--workdir", args.workdir or "build/examples/lifelong_demo",
            "--topics", "64", "--vocab", "4096", "--docs", "256",
            "--minibatch", "256", "--steps", "12", "--publish-every", "3",
            "--requests", "256", "--hot-rows", "512",
        ]
    report = lifelong.main(argv + ["--device", args.device])
    if report["failed_requests"] or report["uncommitted_versions"]:
        raise SystemExit(f"lifelong serving lost requests or served an "
                         f"uncommitted version: {report}")
    return report


if __name__ == "__main__":
    main()
