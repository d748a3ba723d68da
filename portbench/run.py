"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run it from the root of a checkout.  It exits with another code than 0,
and prints no result, when there is no CUDA device (it never falls back to
the CPU), when a file the cell names is missing, when the process holds
JAX or the JAX package after the window, or when the run wrote more than
4 GiB to disk.  The numbers that decide ``correct`` are printed, each
beside its limit, as the last lines of standard error and under the result
line's last key, ``checks``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness

    manifest = harness.load_manifest(ROOT)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        device, T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"the process holds JAX or the JAX package: {held}",
              file=sys.stderr)
        return 4
    written = harness.bytes_written()
    print(f"bytes written to disk: {written}", file=sys.stderr)
    if written > harness.MAX_WRITE_BYTES:
        print(f"the run wrote more than {harness.MAX_WRITE_BYTES} bytes",
              file=sys.stderr)
        return 5
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)     # no teardown of the freed program's host buffers


if __name__ == "__main__":
    sys.exit(main())
