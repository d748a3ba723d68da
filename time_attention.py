"""Time the attention kernels of one source tree on the card.

    python3 time_attention.py --tree DIR [--phases forward backward]

imports ``chip_smoke.py`` from ``DIR`` (a checkout of this repository; that
script puts the tree's own ``src/`` first on the path, so the kernels of
``DIR`` are built and run) and runs its attention phases: ``forward``,
``attention_kernel_phase`` (the flash-attention kernel at the LM's prefill
and decode shapes), and ``backward``, ``attention_backward_phase`` (the
backward kernels at the training shapes, with their checks).  Each phase
prints its ``attention kernel`` / ``attention backward kernel`` lines as
``chip_smoke.py`` does; then one JSON line: the tree, the card's name and
power limit, and per phase and case the kernel's ms (and, where the phase
times one, its CUDA-graph ms and the library call's ms).  Needs one CUDA
card.  To compare two trees, alternate them within one machine's run:
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--phases", nargs="+", default=["forward", "backward"],
                    choices=["forward", "backward"])
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    report, out = {}, {}
    if "forward" in args.phases:
        chip_smoke.attention_kernel_phase(torch, dev, report)
        out["forward"] = {r["case"]: {k: r.get(k) for k in
                                      ("ms", "graph_ms", "library_ms")}
                          for r in report["attention_lines"]}
    if "backward" in args.phases:
        chip_smoke.attention_backward_phase(torch, dev, report)
        out["backward"] = {r["case"]: {k: r.get(k) for k in
                                       ("ms", "library_ms")}
                           for r in report["attention_backward_lines"]}
    print("time_attention " + json.dumps({"tree": tree, "card": card,
                                          **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
