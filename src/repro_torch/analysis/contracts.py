"""Declarative launch contracts for every Hopper kernel the port launches.

The counterpart of the JAX package's ``repro.analysis.contracts``: there a
contract reproduces a ``pl.pallas_call`` site's BlockSpecs; here one
:class:`LaunchContract` reproduces, as data, what a ``__global__``
kernel's C entry launches at a :class:`~repro_torch.analysis.budget.Cell`
— the template instantiation it picks (``variant``), grid, threads, static
and dynamic shared memory, ``__launch_bounds__``, and for the persistent
cooperative loops the CTAs asked for and the cap an SM — with the limits
of the path it takes (``capacities``) and the byte counts its 16-byte
accesses need aligned (``vectors``).  ``analysis.checks`` holds the spec
against the budget model; ``analysis.card`` holds it against the card's own
launch records and resource report.

Contracts are registered at a launch's high-water configuration (the stop
rule on, the exclusion and the residual on, scheduled where there is a
variant); the keyword options of ``spec`` give the other configurations
the wrappers launch.  ``theta_sweep``'s three kernels have one contract for
each serving φ storage type, as in the JAX package: on Hopper φ's element
size moves the register paths' row ring (``GROUP_ROWS`` rows a reduction,
``RING_BUDGET`` bytes), not whether φ fits.  The attention kernels are
quarantined LM code (``analysis.modules``) and have no contract.

This module imports nothing but the budget model: the lint and the CLI
load it without a card or a build.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

from repro_torch.analysis.budget import (
    H100,
    Cell,
    Hopper,
    LaunchSpec,
    ceil_div,
    cooperative_grid,
    ctas_per_sm,
    reg_ceiling,
    round_up,
)

#: Registers a thread by (kernel, variant), as the card reports them
#: (``analysis.card``); a kernel missing here is taken at the ceiling its
#: ``__launch_bounds__`` allow.
Registers = Mapping[Tuple[str, int], int]

# ---------------------------------------------------------------------------
# The C sources' constants
# ---------------------------------------------------------------------------

#: Serving φ storage: element bytes by ``InferPlan.phi_dtype``.
PHI_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
_PHI_CODE = {"float32": 0, "bfloat16": 1, "int8": 2}
_PHI_TAG = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}

# csrc/theta_sweep.cu
THETA_REG_THREADS = 512            # register paths: threads a CTA
THETA_REG_MAX_K = 512 * 4 * 5      # 5 four-lane groups a thread
THETA_WIDE_THREADS = 1024          # wide path
#: Dynamic shared memory of a register-path CTA: two CTAs an SM.
RING_BUDGET = 108 * 1024
MAX_SLOTS = 8
SCHED_STAGE = 1024                 # (token, lane) entries a staging buffer
#: Rows that share one block reduction, by φ element size.
GROUP_ROWS = {4: 1, 2: 2, 1: 4}
#: The wide path's 3·K floats of state in shared memory (the 227 KB opt-in
#: less 1 KB of margin); above it they go to a global scratch.
THETA_STATE_BUDGET = 232_448 - 1024

# csrc/gs_sweep.cu, csrc/sweep_common.cuh, csrc/sweep_active.cuh
GS_THREADS, GS_CTAS_PER_SM, GS_GROUP_DOCS = 512, 2, 4
GS_REG_GROUPS = 512 * 5            # float4 lane groups in registers
LOGLIK_THREADS = 512
ACTIVE_THREADS = 256
PASS_CTAS_PER_SM = 4
LOOP_CTAS_PER_SM = 2

# csrc/sharded_sweep.cu
WARP_THREADS = 256                 # probe, u and topk CTAs: 8 warps
PROBE_CTAS_PER_SM = 4
DENSE_THREADS, DENSE_CTAS_PER_SM = 512, 2

# csrc/fused_estep.cu
ESTEP_REG_THREADS = 512
ESTEP_REG_MAX_K = 512 * 5 * 4
ESTEP_TWO_PASS_THREADS = 256

def static_smem(*arrays: Tuple[int, int]) -> int:
    """A kernel's static shared memory: its ``__shared__`` arrays, each
    ``(bytes, alignment)``, laid out in declaration order at their
    alignments, the total rounded up to 16 bytes (as the compiler
    allocates it)."""
    off = 0
    for nbytes, align in arrays:
        off = round_up(off, align) + nbytes
    return round_up(off, 16)


#: ``__shared__ float red[33]``: the fixed-order block sum's scratch.
RED33 = static_smem((33 * 4, 4))


def theta_static_smem(group: int) -> int:
    """The register paths' static shared memory: the groups' reductions
    ``red[(G + 1)·32]``, the normalisers' ``red1[33]``, the ring's eight
    ``uint64_t`` mbarriers and ``state[3]``."""
    return static_smem((4 * (group + 1) * 32, 4), (33 * 4, 4), (8 * 8, 8),
                       (3 * 4, 4))


class ThetaRing(NamedTuple):
    """The register paths' φ-row ring: ``slots`` slots of ``stride``
    bytes, the staged token columns at ``meta_off``, ``smem`` bytes of
    dynamic shared memory; ``room`` the ring's budget after the columns and
    ``sched`` the scheduled fit's state bytes."""
    slots: int
    stride: int
    meta_off: int
    smem: int
    room: int
    sched: int


def theta_ring(K: int, A: int, L: int, itemsize: int) -> ThetaRing:
    """The ring ``theta_sweep`` sizes at width K, A active topics (0:
    dense), L columns and φ of ``itemsize``-byte elements."""
    row = K * itemsize
    stride = round_up(row, 16) + 16
    room = RING_BUDGET - 16 * L
    slots = min(MAX_SLOTS, max(room, 0) // stride)
    sched = 8 * K + 16 * SCHED_STAGE if A else 0
    meta_off = round_up(max(slots * stride, sched), 16)
    return ThetaRing(slots, stride, meta_off, meta_off + 16 * L, room, sched)


def _spec(kernel: str, variant: int, grid: int, threads: int,
          bounds: Tuple[int, int], hw: Hopper, regs: Optional[Registers], *,
          static: int = 0, dynamic: int = 0, cooperative: bool = False,
          want: int = 0, per_sm: int = 0, vectors=(), capacities=()
          ) -> LaunchSpec:
    r = (regs or {}).get((kernel, variant)) or reg_ceiling(bounds, hw)
    if cooperative:
        occ = ctas_per_sm(threads, r, static, dynamic, hw, bounds[0])
        grid = cooperative_grid(want, occ, per_sm, hw)
    return LaunchSpec(kernel=kernel, variant=variant, grid=grid,
                      threads=threads, static_smem=static,
                      dynamic_smem=dynamic, bounds=bounds, regs=r,
                      cooperative=cooperative, want=want, per_sm=per_sm,
                      vectors=tuple(vectors), capacities=tuple(capacities))


# ---------------------------------------------------------------------------
# theta_sweep — frozen-φ inference: register paths and the wide path
# ---------------------------------------------------------------------------

def _theta_reg_build(scheduled: bool, phi_dtype: str):
    itemsize = PHI_ITEMSIZE[phi_dtype]
    group = GROUP_ROWS[itemsize]
    kernel = "theta_sweep_sched" if scheduled else "theta_sweep_dense"

    def build(cell: Cell, hw: Hopper = H100, regs: Optional[Registers] = None,
              *, vec: Optional[bool] = None, offset: int = 0) -> LaunchSpec:
        K, L = cell.K, cell.L
        A = max(cell.A, 1) if scheduled else 0
        row = K * itemsize
        if vec is None:
            vec = row % 16 == 0 and offset % 16 == 0
        ring = theta_ring(K, A, L, itemsize)
        caps = [("topic lanes a CTA holds in registers", K, THETA_REG_MAX_K),
                ("ring slots (two reductions' rows)", 2 * group, ring.slots)]
        if scheduled:
            caps += [("active topics a staging buffer takes", A, SCHED_STAGE),
                     ("scheduled state bytes in the ring's room", ring.sched,
                      ring.room)]
        return _spec(
            kernel, 2 * _PHI_CODE[phi_dtype] + (0 if vec else 1),
            max(cell.D, 1), THETA_REG_THREADS, (THETA_REG_THREADS, 2), hw,
            regs, static=theta_static_smem(group), dynamic=ring.smem,
            vectors=(("phi row bytes", row), ("phi base address", offset))
            if vec else (),
            capacities=caps)

    return build


def _theta_wide_build(phi_dtype: str):
    def build(cell: Cell, hw: Hopper = H100, regs: Optional[Registers] = None,
              *, state: Optional[str] = None) -> LaunchSpec:
        K = cell.K
        if state is None:
            state = "shared" if 12 * K <= THETA_STATE_BUDGET else "scratch"
        shared = state == "shared"
        return _spec(
            "theta_sweep_wide",
            2 * _PHI_CODE[phi_dtype] + (1 if cell.A else 0),
            max(cell.D, 1), THETA_WIDE_THREADS, (THETA_WIDE_THREADS, 1), hw,
            regs, static=RED33, dynamic=12 * K if shared else 0,
            capacities=(("state bytes in shared memory", 12 * K,
                         THETA_STATE_BUDGET),) if shared else ())

    return build


def theta_contract(path: str, phi_dtype: str = "float32") -> str:
    """The registry name of ``theta_sweep``'s ``path`` kernel (``"dense"``,
    ``"sched"`` or ``"wide"``) at a φ storage type."""
    return f"theta_sweep_{path}{_PHI_TAG[phi_dtype]}"


# ---------------------------------------------------------------------------
# The training sweeps: gs_sweep, the stop rule, the scheduled column loop
# ---------------------------------------------------------------------------

def _gs_loop_spec(cell: Cell, hw: Hopper = H100,
                  regs: Optional[Registers] = None, *,
                  vec: Optional[bool] = None,
                  wide: Optional[bool] = None) -> LaunchSpec:
    K = cell.K
    groups4 = ceil_div(K, 4)
    if wide is None:
        wide = groups4 > GS_REG_GROUPS
    if vec is None:
        vec = K % 4 == 0
    return _spec(
        "gs_loop_kernel", (0 if vec else 1) | (2 if wide else 0), 0,
        GS_THREADS, (GS_THREADS, GS_CTAS_PER_SM), hw, regs, static=RED33,
        dynamic=0 if wide else 16 * 2 * groups4, cooperative=True,
        want=ceil_div(cell.D, GS_GROUP_DOCS), per_sm=GS_CTAS_PER_SM,
        vectors=(("mu row bytes", 4 * K),) if vec else (),
        capacities=() if wide else (
            ("lane groups a CTA holds in registers", groups4,
             GS_REG_GROUPS),))


def loglik_staged(K: int, hw: Hopper = H100) -> bool:
    """Whether the stop rule keeps w(k) in shared memory: 4·ceil(K/4)
    floats and the 1 KB reserve within the opt-in limit."""
    return 16 * ceil_div(K, 4) + 1024 <= hw.smem_optin


def _loglik_spec(cell: Cell, hw: Hopper = H100,
                 regs: Optional[Registers] = None, *,
                 vec: Optional[bool] = None) -> LaunchSpec:
    K = cell.K
    if vec is None:
        vec = K % 4 == 0
    staged = loglik_staged(K, hw)
    return _spec(
        "sweep_loglik_kernel", (0 if vec else 1) | (0 if staged else 2),
        max(cell.D, 1), LOGLIK_THREADS, (LOGLIK_THREADS, 2), hw, regs,
        static=RED33, dynamic=16 * ceil_div(K, 4) if staged else 0,
        vectors=(("theta/phi row bytes", 4 * K),) if vec else ())


def _stream_grid(n: int, vec: bool, hw: Hopper) -> int:
    want = ceil_div(ceil_div(n, 4) if vec else n, ACTIVE_THREADS)
    return min(want, hw.sms * PASS_CTAS_PER_SM)


def _pass_build(kernel: str):
    def build(cell: Cell, hw: Hopper = H100, regs: Optional[Registers] = None,
              *, offset: int = 0) -> LaunchSpec:
        n = cell.D * cell.L * cell.K
        vec = offset % 16 == 0
        return _spec(kernel, 0, _stream_grid(n, vec, hw), ACTIVE_THREADS,
                     (ACTIVE_THREADS, 1), hw, regs,
                     vectors=(("mu base address", offset),) if vec else ())

    return build


def _loop_want(D: int, nb: int, A: int) -> int:
    work = D * nb * (2 * A if A > 16 else 32)
    return ceil_div(work, ACTIVE_THREADS)


def _active_loop_build(sharded: bool):
    def build(cell: Cell, hw: Hopper = H100, regs: Optional[Registers] = None
              ) -> LaunchSpec:
        return _spec(
            "active_loop_kernel", 1 if sharded else 0, 0, ACTIVE_THREADS,
            (ACTIVE_THREADS, 1), hw, regs, cooperative=True,
            want=_loop_want(cell.D, 1, max(cell.A, 1)),
            per_sm=LOOP_CTAS_PER_SM)

    return build


# ---------------------------------------------------------------------------
# sharded_sweep — the two-phase probe and fold on a rank's K/mp lanes
# ---------------------------------------------------------------------------

def _probe_dense_spec(cell: Cell, hw: Hopper = H100,
                      regs: Optional[Registers] = None, *,
                      vec: Optional[bool] = None) -> LaunchSpec:
    if vec is None:
        vec = cell.K % 4 == 0
    return _spec("probe_dense_kernel", 0 if vec else 1,
                 ceil_div(cell.T, WARP_THREADS // 32), WARP_THREADS,
                 (WARP_THREADS, PROBE_CTAS_PER_SM), hw, regs,
                 vectors=(("row bytes", 4 * cell.K),) if vec else ())


def probe_span(A: int) -> int:
    """Threads a token of the scheduled probe: the least power of two ≥ A,
    at most 32."""
    return min(32, 1 << (max(A, 1) - 1).bit_length())


def _probe_sched_spec(cell: Cell, hw: Hopper = H100,
                      regs: Optional[Registers] = None) -> LaunchSpec:
    span = probe_span(cell.A)
    return _spec("probe_sched_kernel", 0,
                 ceil_div(cell.T * span, WARP_THREADS), WARP_THREADS,
                 (WARP_THREADS, 1), hw, regs)


def _dense_loop_spec(cell: Cell, hw: Hopper = H100,
                     regs: Optional[Registers] = None) -> LaunchSpec:
    vec = cell.K % 4 == 0
    return _spec(
        "dense_loop_kernel", 0 if vec else 1, 0, DENSE_THREADS,
        (DENSE_THREADS, DENSE_CTAS_PER_SM), hw, regs, static=RED33,
        cooperative=True, want=cell.D, per_sm=DENSE_CTAS_PER_SM,
        vectors=(("row bytes", 4 * cell.K),) if vec else ())


def _loglik_u_spec(cell: Cell, hw: Hopper = H100,
                   regs: Optional[Registers] = None) -> LaunchSpec:
    return _spec("loglik_u_kernel", 0, ceil_div(cell.T, WARP_THREADS // 32),
                 WARP_THREADS, (WARP_THREADS, 1), hw, regs)


# ---------------------------------------------------------------------------
# foem_estep / topk_estep — the (T, K) and (T, A) E-steps, the block loop
# ---------------------------------------------------------------------------

def _estep_regs_spec(cell: Cell, hw: Hopper = H100,
                     regs: Optional[Registers] = None, *,
                     exclude: bool = True, residual: bool = True,
                     vec: Optional[bool] = None) -> LaunchSpec:
    K = cell.K
    if vec is None:
        vec = K % 4 == 0
    return _spec(
        "fused_estep_regs",
        (0 if vec else 1) | (2 if residual else 0) | (4 if exclude else 0),
        cell.T, ESTEP_REG_THREADS, (ESTEP_REG_THREADS, 2), hw, regs,
        static=RED33, vectors=(("row bytes", 4 * K),) if vec else (),
        capacities=(("topic lanes a CTA holds in registers", K,
                     ESTEP_REG_MAX_K),))


def _estep_two_pass_spec(cell: Cell, hw: Hopper = H100,
                         regs: Optional[Registers] = None, *,
                         exclude: bool = True, residual: bool = True
                         ) -> LaunchSpec:
    return _spec("fused_estep_two_pass",
                 (1 if residual else 0) | (2 if exclude else 0), cell.T,
                 ESTEP_TWO_PASS_THREADS, (ESTEP_TWO_PASS_THREADS, 1), hw,
                 regs, static=RED33)


def _topk_spec(cell: Cell, hw: Hopper = H100,
               regs: Optional[Registers] = None) -> LaunchSpec:
    return _spec("topk_estep_kernel", 0,
                 ceil_div(cell.T, WARP_THREADS // 32), WARP_THREADS,
                 (WARP_THREADS, 1), hw, regs)


def _topk_loop_spec(cell: Cell, hw: Hopper = H100,
                    regs: Optional[Registers] = None, *,
                    nb: Optional[int] = None) -> LaunchSpec:
    nb = cell.L if nb is None else nb        # one block: the high water
    return _spec("topk_loop_kernel", 0, 0, ACTIVE_THREADS,
                 (ACTIVE_THREADS, 1), hw, regs, cooperative=True,
                 want=_loop_want(cell.D, nb, max(cell.A, 1)),
                 per_sm=LOOP_CTAS_PER_SM)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchContract:
    """One kernel launch's declarative contract.

    ``name`` is the registry key; ``kernel`` the ``__global__`` function in
    ``source`` (under ``kernels/csrc``); ``libraries`` the built libraries
    (``kernels/build.py``) whose entries launch it; ``module``/``entry``
    the Python call site that launches it; ``equations`` the paper
    equations it implements (the lint checks the entry documents them);
    ``applies(cell)`` whether the entry points launch it at that cell (the
    path choices: register or wide, dense or scheduled); ``build(cell, hw,
    regs, **opts)`` the :class:`LaunchSpec`."""

    name: str
    kernel: str
    module: str
    entry: str
    source: str
    libraries: Tuple[str, ...]
    equations: Tuple[str, ...]
    description: str
    build: Callable[..., LaunchSpec]
    applies: Callable[[Cell], bool] = lambda cell: True

    def spec(self, cell: Cell, hw: Hopper = H100,
             regs: Optional[Registers] = None, **opts) -> LaunchSpec:
        return self.build(cell, hw, regs, **opts)


def _theta_contracts():
    out = []
    for dtype in PHI_ITEMSIZE:
        tag = "" if dtype == "float32" else f", {dtype} φ"
        dense, sched = theta_contract("dense", dtype), theta_contract(
            "sched", dtype)

        def registers(cell, dense=dense, sched=sched):
            # the register paths' fit test (checks imports this module)
            from repro_torch.analysis.checks import kernel_fits

            return kernel_fits(sched if cell.A else dense, cell)

        common = dict(module="repro_torch.kernels.theta_sweep",
                      entry="theta_sweep", source="theta_sweep.cu",
                      libraries=("theta_sweep",),
                      equations=("eq. 11", "eq. 21"))
        out += [
            LaunchContract(
                name=dense, kernel="theta_sweep_dense",
                description="frozen-φ fixed point, register path" + tag,
                build=_theta_reg_build(False, dtype),
                applies=lambda c, r=registers: not c.A and r(c), **common),
            LaunchContract(
                name=sched, kernel="theta_sweep_sched",
                description="frozen-φ scheduled fit, register path" + tag,
                build=_theta_reg_build(True, dtype),
                applies=lambda c, r=registers: bool(c.A) and r(c), **common),
            LaunchContract(
                name=theta_contract("wide", dtype), kernel="theta_sweep_wide",
                description="frozen-φ fixed point, wide path (state in "
                            "shared memory or a global scratch)" + tag,
                build=_theta_wide_build(dtype),
                applies=lambda c, r=registers: not r(c), **common),
        ]
    return out


def _scheduled(cell: Cell) -> bool:
    return bool(cell.A)


def _dense(cell: Cell) -> bool:
    return not cell.A


def _registry() -> Dict[str, LaunchContract]:
    gs = dict(module="repro_torch.kernels.gs_sweep", source="gs_sweep.cu",
              libraries=("gs_sweep",))
    sched = dict(module="repro_torch.kernels.scheduled_sweep",
                 entry="scheduled_sweep", source="sweep_active.cuh")
    shard = dict(module="repro_torch.kernels.sharded_sweep",
                 source="sharded_sweep.cu", libraries=("sharded_sweep",))
    estep = dict(module="repro_torch.kernels.foem_estep",
                 entry="fused_estep", source="fused_estep.cu",
                 libraries=("fused_estep",),
                 equations=("eq. 11", "eq. 13", "eq. 36"))
    topk = dict(module="repro_torch.kernels.topk_estep",
                source="topk_estep.cu", libraries=("topk_estep",))
    contracts = _theta_contracts() + [
        LaunchContract(
            name="gs_loop_kernel", kernel="gs_loop_kernel", entry="gs_sweep",
            equations=("eq. 13", "eq. 36"),
            description="dense Gauss-Seidel column loop (cooperative)",
            build=_gs_loop_spec, **gs),
        LaunchContract(
            name="sweep_loglik_kernel", kernel="sweep_loglik_kernel",
            module="repro_torch.kernels.gs_sweep",
            entry="sweep_loglik_partials", source="sweep_common.cuh",
            libraries=("gs_sweep", "scheduled_sweep"), equations=("eq. 3",),
            description="the sweeps' stop rule: eq. 3 per-token partials",
            build=_loglik_spec),
        LaunchContract(
            name="active_loop_kernel", kernel="active_loop_kernel",
            libraries=("scheduled_sweep",),
            equations=("eq. 13", "eq. 38", "eq. 36"),
            description="scheduled column loop on the active sets "
                        "(cooperative)",
            build=_active_loop_build(False), applies=_scheduled, **sched),
        LaunchContract(
            name="copy_kernel", kernel="copy_kernel",
            libraries=("scheduled_sweep", "sharded_sweep", "topk_estep"),
            equations=("eq. 38",),
            description="streaming pass: μ copied, inactive lanes keep μ_old",
            build=_pass_build("copy_kernel"), applies=_scheduled, **sched),
        LaunchContract(
            name="zero_kernel", kernel="zero_kernel",
            libraries=("scheduled_sweep", "sharded_sweep"),
            equations=("eq. 36",),
            description="streaming pass: the residual zeroed",
            build=_pass_build("zero_kernel"), applies=_scheduled, **sched),
        LaunchContract(
            name="probe_dense_kernel", kernel="probe_dense_kernel",
            entry="sharded_probe", equations=("eq. 13",),
            description="two-phase sharded sweep, phase A, dense",
            build=_probe_dense_spec, applies=_dense, **shard),
        LaunchContract(
            name="probe_sched_kernel", kernel="probe_sched_kernel",
            entry="sharded_probe", equations=("eq. 13", "eq. 38"),
            description="two-phase sharded sweep, phase A, scheduled",
            build=_probe_sched_spec, applies=_scheduled, **shard),
        LaunchContract(
            name="dense_loop_kernel", kernel="dense_loop_kernel",
            entry="sharded_fold", equations=("eq. 13", "eq. 36"),
            description="two-phase sharded sweep, phase C, dense column "
                        "loop (cooperative)",
            build=_dense_loop_spec, applies=_dense, **shard),
        LaunchContract(
            name="active_loop_kernel_sharded", kernel="active_loop_kernel",
            module="repro_torch.kernels.sharded_sweep", entry="sharded_fold",
            source="sweep_active.cuh", libraries=("sharded_sweep",),
            equations=("eq. 13", "eq. 38", "eq. 36"),
            description="two-phase sharded sweep, phase C, scheduled column "
                        "loop (cooperative)",
            build=_active_loop_build(True), applies=_scheduled),
        LaunchContract(
            name="loglik_u_kernel", kernel="loglik_u_kernel",
            entry="sharded_fold", equations=("eq. 3",),
            description="two-phase sharded sweep, pre-log eq. 3 partials",
            build=_loglik_u_spec, **shard),
        LaunchContract(
            name="fused_estep_regs", kernel="fused_estep_regs",
            description="(T, K) E-step, register path",
            build=_estep_regs_spec,
            applies=lambda c: c.K <= ESTEP_REG_MAX_K, **estep),
        LaunchContract(
            name="fused_estep_two_pass", kernel="fused_estep_two_pass",
            description="(T, K) E-step, two-pass path (wide K)",
            build=_estep_two_pass_spec,
            applies=lambda c: c.K > ESTEP_REG_MAX_K, **estep),
        LaunchContract(
            name="topk_estep_kernel", kernel="topk_estep_kernel",
            entry="topk_estep", equations=("eq. 13", "eq. 38"),
            description="(T, A) active-set E-step",
            build=_topk_spec, applies=_scheduled, **topk),
        LaunchContract(
            name="topk_loop_kernel", kernel="topk_loop_kernel",
            entry="blocked_sweep", equations=("eq. 13", "eq. 38", "eq. 36"),
            description="blocked / scan scheduled sweep's block loop "
                        "(cooperative)",
            build=_topk_loop_spec, applies=_scheduled, **topk),
    ]
    return {c.name: c for c in contracts}


KERNEL_CONTRACTS: Dict[str, LaunchContract] = _registry()

#: Names of each kernel's template instantiations, by the variant number
#: its C entry records (``csrc/launch_log.cuh``).
VARIANTS: Dict[str, Tuple[str, ...]] = {
    "theta_sweep_dense": tuple(f"{d} {v}" for d in PHI_ITEMSIZE
                               for v in ("16B", "scalar")),
    "theta_sweep_sched": tuple(f"{d} {v}" for d in PHI_ITEMSIZE
                               for v in ("16B", "scalar")),
    "theta_sweep_wide": tuple(f"{d} {v}" for d in PHI_ITEMSIZE
                              for v in ("dense", "scheduled")),
    "gs_loop_kernel": ("registers 16B", "registers scalar", "wide 16B",
                       "wide scalar"),
    "sweep_loglik_kernel": ("staged 16B", "staged scalar", "unstaged 16B",
                            "unstaged scalar"),
    "active_loop_kernel": ("unsharded", "sharded"),
    "copy_kernel": ("",),
    "zero_kernel": ("",),
    "probe_dense_kernel": ("16B", "scalar"),
    "probe_sched_kernel": ("",),
    "dense_loop_kernel": ("16B", "scalar"),
    "loglik_u_kernel": ("",),
    "fused_estep_regs": tuple(
        " ".join(x for x in (("exclude" if v & 4 else ""),
                             ("residual" if v & 2 else ""),
                             ("scalar" if v & 1 else "16B")) if x)
        for v in range(8)),
    "fused_estep_two_pass": ("", "residual", "exclude",
                             "exclude residual"),
    "topk_estep_kernel": ("",),
    "topk_loop_kernel": ("",),
}

#: Every kernel function with a contract, by its CUDA source.
CONTRACT_KERNELS = frozenset(c.kernel for c in KERNEL_CONTRACTS.values())


def variant_name(kernel: str, variant: int) -> str:
    """A launch's template instantiation, readably."""
    names = VARIANTS.get(kernel)
    if names is not None and 0 <= variant < len(names):
        return names[variant]
    return str(variant)
