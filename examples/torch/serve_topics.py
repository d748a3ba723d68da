"""Serve topic mixtures for unseen documents with the PyTorch port, against
a trained, disk-backed φ̂ (run examples/torch/train_foem_stream.py first,
or this script trains a small model itself when the workdir is empty).

Serving routes through the frozen-φ inference dispatch
(``kernels.ops.infer``, the ``theta_sweep`` kernel on the card):
convergence-stopped θ-only fixed point, batched and bucketized over the
request stream (``TopicServer.infer_stream``).

    PYTHONPATH=src python examples/torch/serve_topics.py           # full demo
    PYTHONPATH=src python examples/torch/serve_topics.py --quick --device cpu

    # multi-replica pool: Zipf/Poisson traffic over N worker processes
    PYTHONPATH=src python examples/torch/serve_topics.py --replicas 2
"""
import argparse
import os

from repro_torch.core.streaming import ParameterStore
from repro_torch.launch import serve, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="a small store and 64 requests")
    ap.add_argument("--replicas", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="store directory (default build/examples/serve_"
                         "smoke or serve_demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        workdir = args.workdir or "build/examples/serve_smoke"
        topics, vocab = 16, 400
        train_args = ["--docs", "200", "--minibatch", "64", "--steps", "3",
                      "--active-topics", "4", "--log-every", "2"]
        serve_args = ["--requests", "64", "--batch", "32",
                      "--active-topics", "4"]
    else:
        workdir = args.workdir or "build/examples/serve_demo"
        topics, vocab = 100, 5000
        train_args = ["--docs", "1500", "--minibatch", "256", "--steps",
                      "10", "--active-topics", "8", "--log-every", "5"]
        serve_args = ["--requests", "512", "--batch", "64"]
    if args.replicas > 1:
        # pool serving is traffic-driven: replay a Zipf/Poisson trace
        # through the admission router in front of N worker processes
        serve_args += ["--traffic", "--replicas", str(args.replicas),
                       "--qps", "200"]
    common = ["--workdir", workdir, "--topics", str(topics),
              "--vocab", str(vocab), "--device", args.device]
    if not os.path.exists(os.path.join(workdir, ParameterStore.BACKING)):
        print("[demo] no trained store found — training a small one first")
        train.main(common + train_args)
    serve.main(common + serve_args)


if __name__ == "__main__":
    main()
