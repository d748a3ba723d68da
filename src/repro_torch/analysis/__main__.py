"""CLI of the static launch-contract analyzer.

Usage::

    python -m repro_torch.analysis --all          # default + reference cells
    python -m repro_torch.analysis --reference    # reference cells (the gate)
    python -m repro_torch.analysis --cell D=256,L=64,K=128,W_s=8192,A=16
    python -m repro_torch.analysis --all --fail-only

It needs no GPU: the contracts are checked against the H100's limits with
each kernel's registers at the ceiling of its ``__launch_bounds__``.  Exit
status is non-zero iff any (contract, cell) report fails.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.budget import Cell
from repro_torch.analysis.checks import (
    REFERENCE_CELLS,
    check_all,
    default_cells,
    format_reports,
    summarize,
)


def _parse_cell(text: str) -> Cell:
    fields = {}
    for part in text.split(","):
        key, _, val = part.partition("=")
        fields[key.strip()] = int(val)
    try:
        return Cell(**fields)
    except TypeError as e:
        raise SystemExit(
            f"bad --cell {text!r} (want D=..,L=..,K=..,W_s=..[,A=..]): {e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static shared-memory / occupancy / contract analysis "
        "of the port's Hopper kernels at a grid of problem-shape cells.")
    p.add_argument("--all", action="store_true",
                   help="sweep the default grid plus every reference cell")
    p.add_argument("--reference", action="store_true",
                   help="reference cells only: the gate")
    p.add_argument("--cell", action="append", default=[],
                   metavar="D=..,L=..,K=..,W_s=..,A=..",
                   help="add an explicit cell (repeatable)")
    p.add_argument("--fail-only", action="store_true",
                   help="print only failing reports")
    args = p.parse_args(argv)

    if args.reference:
        cells = list(REFERENCE_CELLS)
    elif args.all or not args.cell:
        cells = default_cells()          # includes the reference cells
    else:
        cells = []
    cells += [(f"cli {c}", _parse_cell(c), None) for c in args.cell]
    reports = check_all(cells)
    shown = [r for r in reports if not r.ok] if args.fail_only else reports
    if shown:
        print(format_reports(shown))
    print(summarize(reports))
    return 0 if all(r.ok for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
