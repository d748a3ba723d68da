"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size, many seeds in one process.

    python3 portbench/control.py --workload <cell> --mode program \\
        --seeds 1 2 3 ... [--seconds 3]
    python3 portbench/control.py --workload <cell> --mode control \\
        --seeds 1 2 3 [--dtype bfloat16]
    python3 portbench/control.py --workload <cell> --mode fault \\
        --fault half --seeds 1 2 3 [--seconds 3]

``program``: a whole run of the cell (set-up, a short window at the cell's
load, the reference) a seed; prints the numbers the reference compares.
The largest over the seeds is the lower reading.

``fault``: a whole run as ``program``, with ``--fault`` (``faults.py``:
unchanged, half, token) planted underneath; the smallest number over the
seeds is that fault's reading.

``control``: the reference itself, computed in ``--dtype`` (bfloat16, the
precision below the configuration's float32), stands in the program's
place and is judged by the float32 reference, a seed at a time; the
smallest number over the seeds is the upper reading.

One JSON line a seed on standard output.  The benchmark's own runs never
run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control", "fault"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--fault", default="unchanged")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import faults, harness
    from portbench.drivers import common

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    files = harness.cell_files(ROOT, harness.load_manifest(ROOT),
                               args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        if args.mode in ("program", "fault"):
            if args.mode == "fault":
                module, attr, broken = faults.plant(files["mix"], args.fault)
                real = getattr(module, attr)
                setattr(module, attr, broken)
            try:
                result, checks = harness.run_cell(
                    ROOT, args.workload, seed, args.seconds, False, device,
                    time.perf_counter())
            finally:
                if args.mode == "fault":
                    setattr(module, attr, real)
            numbers = {k: v for k, (v, _) in checks.items()}
            numbers.update(result["info"]["not_compared"])
            extra = {"correct": result["correct"],
                     "metrics": result["metrics"]}
        else:
            driver = harness.make_driver(files, seed, device)
            driver.stand_in(getattr(torch, args.dtype))
            numbers = driver.check()
            extra = {}
        common.free_device(device)
        if args.mode == "fault":
            extra["fault"] = args.fault
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t, **extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
