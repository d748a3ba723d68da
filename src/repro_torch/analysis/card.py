"""Hold the launch contracts against the card's own records.

Each CUDA library of the port records its launches
(``csrc/launch_log.cuh``: the distinct (variant, grid, threads, dynamic
shared memory) configurations of each kernel) and answers one query per
``__global__`` function: its attributes (registers, static shared memory,
local bytes, max threads), the runtime's CTAs an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) at a thread count and
dynamic shared memory, and its last launch.  :func:`check_against_card`
rebuilds every launch the wrappers noted (``analysis.launches``) from its
contract, with the card's SM count and each variant's registers, and
requires:

* the noted launches' specs and the libraries' records to be the same set
  of (kernel, variant, grid, threads, dynamic shared memory) — a launch
  the contract does not predict, or a predicted one the card never saw,
  is a mismatch;
* each recorded configuration's predicted CTAs an SM (``budget``) to equal
  the runtime's, and the contract's static shared memory the card's.

It also reads the compiler's resource report (``build.build_log``, from
``-Xptxas -v``): registers, static shared memory and spill bytes of every
entry function.  Runs on the machine with the card, after the launches it
checks, never inside a CUDA graph capture.
"""
from __future__ import annotations

import ctypes
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import launches
from repro_torch.analysis.budget import Hopper, ctas_per_sm, device_limits
from repro_torch.analysis.contracts import (
    CONTRACT_KERNELS,
    KERNEL_CONTRACTS,
    variant_name,
)

#: The fields of a kernel query, in ``launch_log::query``'s order.
QUERY_FIELDS = ("regs", "static_smem", "local_bytes", "max_threads",
                "occupancy", "last_grid", "last_threads", "last_smem",
                "launches", "configs")

#: Kernels of the libraries without a contract (quarantined LM code),
#: reported with their resources only.
UNCONTRACTED = ("flash_attention_kernel", "flash_attention_bf16_kernel",
                "flash_attention_bwd_delta_kernel",
                "flash_attention_bwd_dkdv_kernel",
                "flash_attention_bwd_dq_kernel",
                "flash_attention_bwd_dkdv_bf16_kernel",
                "flash_attention_bwd_dq_bf16_kernel")


def _library(name: str) -> ctypes.CDLL:
    from repro_torch.kernels import build

    return build.load(name)


def _fn(lib: ctypes.CDLL, symbol: str, restype, argtypes):
    """``symbol`` of ``lib`` with its signature; the restype is set before
    the argtypes that mark the set-up done, so a thread that finds it done
    finds it whole."""
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = restype
        fn.argtypes = argtypes
    return fn


def launch_configs(library: str) -> Tuple[List[Dict], int]:
    """The library's distinct launch configurations (kernel, variant,
    grid, threads, smem, launches) and the launches its full table could
    not record."""
    fn = _fn(_library(library), f"{library}_launch_config", ctypes.c_char_p,
             [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)])
    out = (ctypes.c_longlong * 5)()
    configs, i = [], 0
    while True:
        name = fn(i, out)
        if name is None:
            return configs, int(out[1])
        configs.append(dict(kernel=name.decode(), variant=int(out[0]),
                            grid=int(out[1]), threads=int(out[2]),
                            smem=int(out[3]), launches=int(out[4])))
        i += 1


def reset(library: str) -> None:
    """Forget the library's launch records."""
    _fn(_library(library), f"{library}_launch_reset", None, [])()


def query(library: str, kernel: str, variant: int, threads: int,
          smem: int) -> Optional[Dict[str, int]]:
    """``kernel``'s ``variant`` as the card sees it (:data:`QUERY_FIELDS`),
    with the runtime's CTAs an SM at ``threads`` and ``smem`` bytes of
    dynamic shared memory; None if the variant has not launched."""
    fn = _fn(_library(library), f"{kernel}_query", ctypes.c_int,
             [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
              ctypes.POINTER(ctypes.c_longlong)])
    out = (ctypes.c_longlong * len(QUERY_FIELDS))()
    rc = fn(variant, threads, smem, out)
    if rc == -1:
        return None
    if rc != 0:
        raise RuntimeError(f"{kernel}_query({variant}) failed: CUDA error "
                           f"{rc}")
    return dict(zip(QUERY_FIELDS, (int(v) for v in out)))


# ---------------------------------------------------------------------------
# The compiler's resource report
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Per entry function (mangled name) of an ``-Xptxas -v`` report:
    registers, static shared memory, stack frame and spill bytes."""
    out: Dict[str, Dict[str, int]] = {}
    current = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILL.search(line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m and current is not None:
            smem = _SMEM.search(line)
            out[current].update(regs=int(m.group(1)),
                                smem=int(smem.group(1)) if smem else 0)
    return out


def kernel_of(mangled: str, names) -> Optional[str]:
    """Which of ``names`` a mangled entry function instantiates (its
    length-prefixed source name)."""
    for name in names:
        if f"{len(name)}{name}" in mangled:
            return name
    return None


def compiler_report(libraries) -> Dict[str, Dict[str, object]]:
    """Per kernel name: the register counts, static shared memory and the
    most spill bytes over its instantiations, from the build logs."""
    from repro_torch.kernels import build

    names = sorted(CONTRACT_KERNELS) + list(UNCONTRACTED)
    out: Dict[str, Dict[str, object]] = {}
    for lib in libraries:
        for mangled, r in parse_ptxas(build.build_log(lib)).items():
            name = kernel_of(mangled, names)
            if name is None:
                continue
            k = out.setdefault(name, {"regs": set(), "smem": set(),
                                      "spill_bytes": 0})
            k["regs"].add(r.get("regs", 0))
            k["smem"].add(r.get("smem", 0))
            k["spill_bytes"] = max(k["spill_bytes"],
                                   r.get("spill_stores", 0)
                                   + r.get("spill_loads", 0))
    return {n: {"regs": sorted(k["regs"]), "smem": sorted(k["smem"]),
                "spill_bytes": k["spill_bytes"]} for n, k in out.items()}


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def _key(lib, kernel, variant, grid, threads, smem):
    return (lib, kernel, variant, grid, threads, smem)


def check_against_card(libraries=None, hw: Optional[Hopper] = None) -> Dict:
    """Hold every noted launch's contract against the libraries' records
    and the card's occupancy; returns ``{"kernels": [...], "mismatches":
    [...], "noted": n, "recorded": n}`` (an empty ``mismatches`` passes).
    ``libraries`` defaults to every library the process has loaded."""
    from repro_torch.kernels import build

    hw = hw or device_limits()
    libs = list(libraries if libraries is not None else build.loaded())
    recorded, dropped = {}, {}
    for lib in libs:
        recorded[lib], dropped[lib] = launch_configs(lib)
    # the card's registers of every launched variant
    queries: Dict[Tuple, Dict[str, int]] = {}
    for lib in libs:
        for c in recorded[lib]:
            q = query(lib, c["kernel"], c["variant"], c["threads"], c["smem"])
            queries[(lib, c["kernel"], c["variant"], c["threads"],
                     c["smem"])] = q
    regs: Dict[str, Dict[Tuple[str, int], int]] = {lib: {} for lib in libs}
    for (lib, kernel, variant, _, _), q in queries.items():
        regs[lib][(kernel, variant)] = q["regs"]
    mismatches: List[str] = []
    expected, statics, bounds, coop = {}, {}, {}, set()
    for lib, name, cell, opts, n in launches.notes():
        if lib not in recorded:
            mismatches.append(f"{name} @ {cell.label()}: noted for library "
                              f"{lib}, which is not loaded")
            continue
        spec = KERNEL_CONTRACTS[name].spec(cell, hw, regs[lib], **opts)
        key = _key(lib, spec.kernel, spec.variant, spec.grid, spec.threads,
                   spec.dynamic_smem)
        expected.setdefault(key, []).append((name, cell, opts))
        statics[(spec.kernel, spec.variant)] = spec.static_smem
        bounds[(spec.kernel, spec.variant)] = spec.bounds[0]
        if spec.cooperative:
            coop.add(spec.kernel)
    seen = set()
    rows: Dict[Tuple[str, int], Dict] = {}
    for lib in libs:
        if dropped[lib]:
            mismatches.append(f"{lib}: {dropped[lib]} launches were not "
                              f"recorded (the table is full)")
        for c in recorded[lib]:
            kv = (c["kernel"], c["variant"])
            q = queries[(lib, c["kernel"], c["variant"], c["threads"],
                         c["smem"])]
            contracted = c["kernel"] in CONTRACT_KERNELS
            static = statics.get(kv, q["static_smem"])
            pred = ctas_per_sm(c["threads"], q["regs"], static, c["smem"], hw,
                               bounds.get(kv))
            key = _key(lib, c["kernel"], c["variant"], c["grid"],
                       c["threads"], c["smem"])
            where = (f"{c['kernel']}<{variant_name(*kv)}> ({lib}) grid "
                     f"{c['grid']} × {c['threads']}, {c['smem']} B")
            if contracted:
                seen.add(key)
                if key not in expected:
                    mismatches.append(f"{where}: launched {c['launches']}× "
                                      "but no noted launch's contract "
                                      "predicts it")
                if static != q["static_smem"]:
                    mismatches.append(
                        f"{where}: contract static shared memory {static} "
                        f"B, the card's {q['static_smem']} B")
            if pred != q["occupancy"]:
                mismatches.append(f"{where}: predicted {pred} CTAs an SM, "
                                  f"the card {q['occupancy']}")
            row = rows.setdefault(kv, {
                "kernel": c["kernel"], "variant": variant_name(*kv),
                "library": lib, "contract": contracted, "regs": q["regs"],
                "static_smem": q["static_smem"],
                "local_bytes": q["local_bytes"], "dynamic_smem": [],
                "ctas_per_sm": [], "grids": [], "launches": 0})
            row["dynamic_smem"] = sorted(set(row["dynamic_smem"])
                                         | {c["smem"]})
            pair = [pred, q["occupancy"]]
            if pair not in row["ctas_per_sm"]:
                row["ctas_per_sm"].append(pair)
            row["grids"] = sorted(set(row["grids"]) | {c["grid"]})
            row["launches"] += c["launches"]
    for key, who in expected.items():
        if key not in seen:
            name, cell, opts = who[0]
            mismatches.append(
                f"{name} @ {cell.label()} {opts}: the contract predicts "
                f"{key[1]}<{variant_name(key[1], key[2])}> grid {key[3]} × "
                f"{key[4]}, {key[5]} B, which {key[0]} never launched")
    for row in rows.values():
        row["cooperative"] = row["kernel"] in coop
        for key in ("grids", "dynamic_smem"):
            vals = row[key]
            if len(vals) > 8:        # a range: the grids follow D
                row[key] = {"min": vals[0], "max": vals[-1],
                            "distinct": len(vals)}
    return {"kernels": sorted(rows.values(),
                              key=lambda r: (r["library"], r["kernel"],
                                             r["variant"])),
            "mismatches": mismatches,
            "noted": sum(len(v) for v in expected.values()),
            "recorded": sum(len(v) for v in recorded.values())}
