"""Static checks of the port's launch contracts against the Hopper model.

``check_all`` sweeps every registered :class:`LaunchContract` that the
entry points launch at a cell over a grid of (D, L, K, W_s, A) cells —
always including the reference cells — and reports, per (contract, cell):

* shared memory: static + dynamic within the 227 KB a CTA may opt in to;
* threads within 1,024 and the kernel's ``__launch_bounds__``, and the
  grid within 1 … 2³¹ − 1;
* predicted CTAs an SM (``budget.ctas_per_sm``) at least the
  ``__launch_bounds__`` minimum — short of it, the compiler has spilled to
  fit the bound or the kernel runs at a fraction of the occupancy its
  design assumed;
* a cooperative launch: at least one CTA an SM, and the grid within
  ``SMs · min(occupancy, per_sm)`` (every CTA co-resident, so its grid
  barrier cannot deadlock);
* 16-byte alignment of every row and base a 16-byte access path reads;
* the path's own capacities (lanes in registers, ring slots, staged state).

A report "fits" only if no rule fails.  ``kernel_fits`` is the dispatch's
question (``theta_sweep.sweep_path``, ``foem_estep.estep_path``), so the
path choice and the analysis share one byte model by construction;
``assert_reference_cells`` is the gate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import budget as bm
from repro_torch.analysis.budget import H100, Cell, Hopper, LaunchSpec
from repro_torch.analysis.contracts import KERNEL_CONTRACTS

#: The kernels of the K = 5·10⁴ (bigmodel) cell's wide paths.
WIDE_KERNELS: Tuple[str, ...] = ("theta_sweep_wide", "gs_loop_kernel",
                                 "fused_estep_two_pass")

#: Named reference cells, each with the contracts it is checked against
#: (None: every contract the entry points launch there).  The JAX
#: package's cells (BENCH_sweep full and quick; the serving benchmark and
#: the ROADMAP target share the full one), then the shapes ``chip_smoke.py``
#: launches: serving (256 documents in 16-token buckets up to 256 columns,
#: K = 10⁴, the stream_1k vocabulary), training (the 1,024 × 128 minibatch),
#: one rank's K/mp = 2,500 lanes of the sharded step, the E-step slabs (an
#: ``iem_blocks=8`` block, T = 16,384; SEM's T = 131,072 is the training
#: cell) and bigmodel's K = 5·10⁴ wide paths.
REFERENCE_CELLS: Tuple[Tuple[str, Cell, Optional[Tuple[str, ...]]], ...] = (
    ("BENCH_sweep full", Cell(D=256, L=64, K=128, W_s=8192, A=16), None),
    ("BENCH_sweep quick", Cell(D=32, L=16, K=32, W_s=512, A=8), None),
    ("serving dense", Cell(D=256, L=256, K=10_000, W_s=141_043), None),
    ("serving A=16", Cell(D=256, L=256, K=10_000, W_s=141_043, A=16), None),
    ("training dense", Cell(D=1024, L=128, K=10_000, W_s=141_043), None),
    ("training A=16", Cell(D=1024, L=128, K=10_000, W_s=141_043, A=16),
     None),
    ("sharded K/mp", Cell(D=1024, L=128, K=2500, W_s=141_043), None),
    ("sharded K/mp A/mp=4", Cell(D=1024, L=128, K=2500, W_s=141_043, A=4),
     None),
    ("estep block T=16384", Cell(D=1024, L=16, K=10_000, W_s=141_043, A=16),
     None),
    ("bigmodel K=50000", Cell(D=32, L=8, K=50_000, W_s=141_043),
     tuple(name for name, c in KERNEL_CONTRACTS.items()
           if c.kernel in WIDE_KERNELS)),
)

#: Exploration grid of ``check_all`` beyond the reference cells.
DEFAULT_GRID_D = (64, 256, 1024)
DEFAULT_GRID_K = (128, 2500, 10_000, 50_000)
DEFAULT_GRID_A = (0, 16)


@dataclasses.dataclass(frozen=True)
class CheckReport:
    """The analyzer's verdict for one (contract, cell) pair."""

    name: str
    label: str
    cell: Cell
    spec: LaunchSpec
    ctas_per_sm: int
    limits: Dict[str, int]
    errors: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.errors

    def reason(self) -> str:
        return self.errors[0] if self.errors else "ok"


def _errors(spec: LaunchSpec, hw: Hopper) -> Tuple[List[str], int, Dict]:
    errs = []
    k = spec.kernel
    if not 1 <= spec.threads <= hw.threads_per_cta:
        errs.append(f"{k}: {spec.threads} threads a CTA, not in 1 … "
                    f"{hw.threads_per_cta}")
    if spec.threads > spec.bounds[0]:
        errs.append(f"{k}: {spec.threads} threads exceed its "
                    f"__launch_bounds__ of {spec.bounds[0]}")
    if not 1 <= spec.grid <= hw.grid_x:
        errs.append(f"{k}: grid {spec.grid} not in 1 … {hw.grid_x}")
    if spec.regs > hw.regs_per_thread:
        errs.append(f"{k}: {spec.regs} registers a thread exceed "
                    f"{hw.regs_per_thread}")
    if spec.smem > hw.smem_optin:
        errs.append(f"{k}: {spec.smem} bytes of shared memory (static "
                    f"{spec.static_smem} + dynamic {spec.dynamic_smem}) "
                    f"exceed the {hw.smem_optin} a CTA may opt in to")
    limits = bm.occupancy_limits(spec.threads, spec.regs, spec.static_smem,
                                 spec.dynamic_smem, hw, spec.bounds[0])
    occ = min(limits.values())
    if occ < max(spec.bounds[1], 1):
        short = min(limits, key=limits.get)
        errs.append(f"{k}: {occ} CTAs an SM (limited by {short}) fall short "
                    f"of its __launch_bounds__ minimum of {spec.bounds[1]}")
    if spec.cooperative:
        cap = hw.sms * min(occ, spec.per_sm)
        if occ < 1 or spec.grid > cap:
            errs.append(f"{k}: cooperative grid {spec.grid} is not "
                        f"co-resident: {hw.sms} SMs × min({occ} CTAs an SM, "
                        f"cap {spec.per_sm}) = {cap}")
    for what, nbytes in spec.vectors:
        if nbytes % 16:
            errs.append(f"{k}: {what} {nbytes} is not a multiple of 16 on "
                        f"its 16-byte access path")
    for what, need, have in spec.capacities:
        if need > have:
            errs.append(f"{k}: {what}: needs {need}, has {have}")
    return errs, occ, limits


def check_spec(spec: LaunchSpec, *, name: str = "", label: str = "",
               cell: Optional[Cell] = None, hw: Hopper = H100) -> CheckReport:
    """Run every static check on one instantiated launch spec."""
    errs, occ, limits = _errors(spec, hw)
    return CheckReport(name=name or spec.kernel, label=label,
                       cell=cell if cell is not None else Cell(0, 0, 0, 0),
                       spec=spec, ctas_per_sm=occ, limits=limits,
                       errors=tuple(errs))


def check_cell(cell: Cell, *, label: str = "",
               kernels: Optional[Sequence[str]] = None,
               hw: Hopper = H100) -> List[CheckReport]:
    """Check every (or the named) contract the entry points launch at one
    cell, at its high-water configuration."""
    names = kernels if kernels is not None else sorted(KERNEL_CONTRACTS)
    out = []
    for name in names:
        c = KERNEL_CONTRACTS[name]
        if not c.applies(cell):
            continue
        out.append(check_spec(c.spec(cell, hw), name=name,
                              label=label or cell.label(), cell=cell, hw=hw))
    return out


def default_cells() -> List[Tuple[str, Cell, Optional[Tuple[str, ...]]]]:
    """The reference cells plus the exploration grid."""
    cells = list(REFERENCE_CELLS)
    for d in DEFAULT_GRID_D:
        for k in DEFAULT_GRID_K:
            for a in DEFAULT_GRID_A:
                c = Cell(D=d, L=128, K=k, W_s=141_043, A=a)
                cells.append((c.label(), c, None))
    return cells


def check_all(cells: Optional[Iterable[Tuple]] = None, *,
              hw: Hopper = H100) -> List[CheckReport]:
    """Sweep the contracts over ``(label, cell, kernels)`` cells (default
    :func:`default_cells`): one report per (contract, cell)."""
    reports = []
    for label, cell, kernels in (cells if cells is not None
                                 else default_cells()):
        reports += check_cell(cell, label=label, kernels=kernels, hw=hw)
    return reports


def assert_reference_cells(hw: Hopper = H100) -> List[CheckReport]:
    """The gate: every contract must verify at every reference cell.
    Raises ``AssertionError`` naming each failing (contract, cell)."""
    reports = check_all(REFERENCE_CELLS, hw=hw)
    bad = [r for r in reports if not r.ok]
    if bad:
        lines = "\n".join(f"  {r.name} @ {r.label}: {r.reason()}"
                          for r in bad)
        raise AssertionError(
            f"{len(bad)} reference launch contract(s) failed:\n{lines}")
    return reports


def kernel_fits(name: str, cell: Cell, hw: Hopper = H100, **opts) -> bool:
    """Whether contract ``name``'s launch at ``cell`` passes every check:
    the path choices of the wrappers ask this."""
    spec = KERNEL_CONTRACTS[name].spec(cell, hw, **opts)
    return not _errors(spec, hw)[0]


def format_reports(reports: Sequence[CheckReport]) -> str:
    """The fixed-width table the CLI prints."""
    header = (f"{'contract':<27} {'cell':<36} {'grid':>8} {'thr':>5} "
              f"{'smem':>7} {'regs':>4} {'CTA/SM':>6} {'fit':<4} note")
    lines = [header, "-" * len(header)]
    for r in reports:
        s = r.spec
        note = r.reason() if not r.ok else (
            "cooperative" if s.cooperative else "")
        lines.append(
            f"{r.name:<27} {r.label:<36} {s.grid:>8} {s.threads:>5} "
            f"{s.smem:>7} {s.regs:>4} {r.ctas_per_sm:>6} "
            f"{'ok' if r.ok else 'FAIL':<4} {note}")
    return "\n".join(lines)


def summarize(reports: Sequence[CheckReport]) -> Dict[str, int]:
    ok = sum(1 for r in reports if r.ok)
    return {"total": len(reports), "ok": ok, "fail": len(reports) - ok}
