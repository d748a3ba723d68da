"""The Hopper launch budget model, shared by dispatch and analysis.

The port's counterpart of the JAX package's TPU budget model
(``repro.analysis.budget``: VMEM live sets over (8, 128) tiles, SMEM
scalar prefetch).  On Hopper what a launch must fit is a streaming
multiprocessor's (SM's) resources, so the model here is the arithmetic of
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: how many CTAs of a
launch one SM holds at once, as the least of five limits —

* **threads**: 2,048 an SM, 1,024 a CTA;
* **warps**: 64 an SM (a CTA's threads rounded up to whole warps);
* **CTAs**: 32 an SM;
* **registers**: 65,536 an SM in four sub-partitions of 16,384; a warp
  takes ``regs · 32`` rounded up to 256, and a sub-partition holds whole
  warps; 255 a thread at most; a CTA's warps are rounded up to a multiple
  of the four sub-partitions for the per-CTA hardware check (65,536);
* **shared memory**: a CTA takes its static and dynamic shared memory plus
  1 KB the runtime reserves, rounded up to 128 bytes, out of the SM's
  228 KB (233,472 bytes); a CTA may opt in to at most 227 KB (232,448
  bytes).

A :class:`LaunchSpec` is one launch as data: grid, threads, static and
dynamic shared memory, ``__launch_bounds__`` (threads, minimum CTAs an SM),
the registers a thread — the card's count from its resource report, or,
where none is known (on the CPU), the ceiling the launch bounds let the
compiler use — and, for a cooperative launch, the CTAs it asks for and its
cap an SM.  The port has no token-block tile to size (its E-step kernels
take one token a CTA), so there is no counterpart of the JAX package's
``estep_token_block``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple


def round_up(n: int, m: int) -> int:
    """Round ``n`` up to a multiple of ``m`` (identity for ``m <= 1``)."""
    if m <= 1:
        return n
    return n + (-n) % m


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Hopper:
    """One card's launch limits; :data:`H100` holds the H100 SXM's."""

    sms: int = 132
    smem_optin: int = 232_448          # dynamic + static a CTA (227 KB)
    smem_per_sm: int = 233_472         # 228 KB an SM
    smem_reserved: int = 1024          # the runtime's reserve a CTA
    smem_granule: int = 128            # shared-memory allocation unit
    regs_per_sm: int = 65_536
    regs_per_cta: int = 65_536
    regs_per_thread: int = 255
    reg_granule: int = 256             # registers a warp, allocation unit
    sub_partitions: int = 4
    warp: int = 32
    threads_per_cta: int = 1024
    threads_per_sm: int = 2048
    warps_per_sm: int = 64
    ctas_per_sm: int = 32
    grid_x: int = 2 ** 31 - 1


H100 = Hopper()


def device_limits(device=0) -> Hopper:
    """The card's limits where it reports them (SMs, shared memory,
    registers, threads), the H100 SXM's constants for the rest.  Needs a
    CUDA device: on the CPU use :data:`H100`."""
    import torch

    p = torch.cuda.get_device_properties(device)
    base = H100
    return dataclasses.replace(
        base,
        sms=p.multi_processor_count,
        smem_optin=getattr(p, "shared_memory_per_block_optin",
                           base.smem_optin),
        smem_per_sm=getattr(p, "shared_memory_per_multiprocessor",
                            base.smem_per_sm),
        regs_per_sm=getattr(p, "regs_per_multiprocessor", base.regs_per_sm),
        threads_per_sm=getattr(p, "max_threads_per_multi_processor",
                               base.threads_per_sm),
        warp=getattr(p, "warp_size", base.warp),
    )


@dataclasses.dataclass(frozen=True)
class Cell:
    """One launch shape: ``D`` documents, ``L`` token columns, ``K`` topic
    lanes, ``W_s`` live vocabulary rows, ``A`` active topics a word
    (0: dense).  The E-step kernels take ``T = D · L`` tokens."""

    D: int
    L: int
    K: int
    W_s: int
    A: int = 0

    @property
    def T(self) -> int:
        return self.D * self.L

    def label(self) -> str:
        base = f"D={self.D} L={self.L} K={self.K} W_s={self.W_s}"
        return base + (f" A={self.A}" if self.A else "")


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """One kernel launch at one :class:`Cell`, as the C entry makes it.

    ``variant`` is the template instantiation's number in the C source's
    query (``contracts.VARIANTS`` names them).  ``bounds`` is the kernel's
    ``__launch_bounds__`` (max threads, min CTAs an SM; 1 when it names
    none).  A cooperative launch asks for ``want`` CTAs and the entry caps
    the grid at ``sms · min(occupancy, per_sm)``: ``grid`` is the capped
    count.  ``vectors`` lists the byte counts (rows, base offsets) that a
    16-byte access path of the launch needs to be multiples of 16;
    ``capacities`` the path's own limits as ``(what, need, have)``."""

    kernel: str
    variant: int
    grid: int
    threads: int
    static_smem: int
    dynamic_smem: int
    bounds: Tuple[int, int]
    regs: int
    cooperative: bool = False
    want: int = 0
    per_sm: int = 0
    vectors: Tuple[Tuple[str, int], ...] = ()
    capacities: Tuple[Tuple[str, int, int], ...] = ()

    @property
    def smem(self) -> int:
        """Static + dynamic shared memory a CTA (bytes)."""
        return self.static_smem + self.dynamic_smem


def smem_per_cta(static: int, dynamic: int, hw: Hopper = H100) -> int:
    """Shared memory one CTA takes of its SM: static + dynamic + the
    runtime's reserve, rounded up to the allocation unit."""
    return round_up(static + dynamic + hw.smem_reserved, hw.smem_granule)


def regs_per_warp(regs: int, hw: Hopper = H100) -> int:
    return round_up(regs * hw.warp, hw.reg_granule)


def regs_per_cta(regs: int, threads: int, hw: Hopper = H100) -> int:
    """Registers one CTA is allocated: whole warps, each ``regs · 32``
    rounded up to the allocation unit."""
    return regs_per_warp(regs, hw) * ceil_div(threads, hw.warp)


def occupancy_limits(threads: int, regs: int, static_smem: int,
                     dynamic_smem: int, hw: Hopper = H100,
                     max_threads: Optional[int] = None) -> Dict[str, int]:
    """CTAs an SM by each limit (threads, warps, CTAs, registers, shared
    memory); 0 where one CTA does not fit at all."""
    warps = ceil_div(threads, hw.warp)
    out = {
        "threads": hw.threads_per_sm // threads if threads else 0,
        "warps": hw.warps_per_sm // warps if warps else 0,
        "ctas": hw.ctas_per_sm,
    }
    if (threads < 1 or threads > hw.threads_per_cta
            or (max_threads is not None and threads > max_threads)):
        out["threads"] = 0
    per_warp = regs_per_warp(regs, hw)
    # the hardware's per-CTA check counts warps in whole sub-partitions
    assumed = per_warp * round_up(warps, hw.sub_partitions)
    if (regs > hw.regs_per_thread or assumed > hw.regs_per_cta
            or regs_per_cta(regs, threads, hw) > hw.regs_per_cta):
        out["registers"] = 0
    elif per_warp == 0:
        out["registers"] = hw.ctas_per_sm
    else:
        per_sub = (hw.regs_per_sm // hw.sub_partitions) // per_warp
        out["registers"] = per_sub * hw.sub_partitions // warps
    smem = smem_per_cta(static_smem, dynamic_smem, hw)
    if static_smem + dynamic_smem > hw.smem_optin:
        out["shared"] = 0
    else:
        out["shared"] = hw.smem_per_sm // smem
    return out


def ctas_per_sm(threads: int, regs: int, static_smem: int,
                dynamic_smem: int, hw: Hopper = H100,
                max_threads: Optional[int] = None) -> int:
    """Predicted CTAs an SM: the least of :func:`occupancy_limits`, the
    arithmetic of ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    return min(occupancy_limits(threads, regs, static_smem, dynamic_smem,
                                hw, max_threads).values())


@functools.lru_cache(maxsize=None)
def reg_ceiling(bounds: Tuple[int, int], hw: Hopper = H100) -> int:
    """The most registers a thread that ``__launch_bounds__(threads,
    min_ctas)`` lets the compiler use: the largest count at which
    ``min_ctas`` CTAs of ``threads`` still fit an SM's register file."""
    threads, min_ctas = bounds
    for regs in range(hw.regs_per_thread, 0, -1):
        lim = occupancy_limits(threads, regs, 0, 0, hw)["registers"]
        if lim >= max(min_ctas, 1):
            return regs
    return 0


def cooperative_grid(want: int, occupancy: int, per_sm: int,
                     hw: Hopper = H100) -> int:
    """The grid ``active::launch_cooperative`` launches: ``want`` CTAs
    (at least 1), capped at what the card holds at once, ``sms ·
    min(occupancy, per_sm)``."""
    cap = hw.sms * min(occupancy, per_sm)
    return max(1, min(want, cap))
