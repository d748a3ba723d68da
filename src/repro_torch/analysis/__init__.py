"""Static launch-contract analysis and the runtime numerical sanitizer.

The port of ``repro.analysis``, rewritten for Hopper:

* :mod:`~repro_torch.analysis.budget` — the Hopper budget model: an SM's
  threads, warps, CTAs, registers and shared memory, and the occupancy
  arithmetic of ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.
* :mod:`~repro_torch.analysis.contracts` — one :class:`LaunchContract`
  per ``__global__`` kernel the entry points launch: grid, threads, shared
  memory, launch bounds and cooperative caps as data.
* :mod:`~repro_torch.analysis.checks` — the static analyzer
  (:func:`check_all`, :func:`assert_reference_cells`) and
  :func:`kernel_fits`, the question the wrappers' path choices ask.
* :mod:`~repro_torch.analysis.validate` — eager argument contracts at
  ``ops.sweep`` / ``ops.infer`` (:class:`ContractError`) and
  :class:`SanitizerError`.
* :mod:`~repro_torch.analysis.sanitizer` — the numerical invariants behind
  ``debug_checks=True``; imported lazily.
* :mod:`~repro_torch.analysis.launches` — the launches the wrappers note
  while enabled, and :mod:`~repro_torch.analysis.card`, which holds the
  contracts against the card's launch records and resource report.
* :mod:`~repro_torch.analysis.modules` and
  :mod:`~repro_torch.analysis.lint` — the port's import graph and lint.

CLI: ``python -m repro_torch.analysis --reference`` (no GPU needed).
"""
from repro_torch.analysis.budget import H100, Cell, Hopper, LaunchSpec
from repro_torch.analysis.checks import (
    REFERENCE_CELLS,
    CheckReport,
    assert_reference_cells,
    check_all,
    check_cell,
    check_spec,
    default_cells,
    format_reports,
    kernel_fits,
    summarize,
)
from repro_torch.analysis.contracts import KERNEL_CONTRACTS, LaunchContract
from repro_torch.analysis.validate import (
    ContractError,
    SanitizerError,
    validate_infer_args,
    validate_sweep_args,
)

__all__ = [
    "Cell",
    "CheckReport",
    "ContractError",
    "H100",
    "Hopper",
    "KERNEL_CONTRACTS",
    "LaunchContract",
    "LaunchSpec",
    "REFERENCE_CELLS",
    "SanitizerError",
    "assert_reference_cells",
    "check_all",
    "check_cell",
    "check_spec",
    "default_cells",
    "format_reports",
    "kernel_fits",
    "sanitizer",
    "summarize",
    "validate_infer_args",
    "validate_sweep_args",
]


def __getattr__(name):
    # the sanitizer is loaded only where debug_checks asks for it
    if name == "sanitizer":
        import repro_torch.analysis.sanitizer as sanitizer

        return sanitizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
