"""One run of one cell: find its files by name, drive the program, measure,
check, and build the result line.

:func:`run_cell` is everything ``run.py`` does once it has found the card;
the CPU tests call it directly with ``device="cpu"`` and a small manifest.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from portbench.trace import DeviceTrace, breakdown

#: top-level module names the process must not hold (JAX and the JAX
#: package), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: bytes a run may write to disk
MAX_WRITE_BYTES = 4 << 30


class ManifestError(ValueError):
    """A cell, configuration, mix, metric or limit that is not there."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise ManifestError(f"missing file {path}")
    return json.loads(path.read_text())


def load_manifest(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(root: Path, manifest: dict, workload: str) -> dict:
    """Everything a cell is made of, by the names the manifest gives:
    its entry, configuration, traffic mix, driver, limits and metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    if cell["config"] not in configs:
        raise ManifestError(f"no config {cell['config']!r}")
    bench = root / "portbench"
    cfg = load_json(root / configs[cell["config"]]["file"])
    mix = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    driver = bench / "drivers" / f"{mix['driver']}.py"
    if not driver.is_file():
        raise ManifestError(f"missing driver {driver}")
    limits = load_json(bench / "limits" / f"{workload}.json")
    e2e = [m for m in manifest["end_to_end"] if reports(m, workload)]
    layer = [m for m in manifest["per_layer"] if reports_layer(
        m, workload, {x["name"] for x in e2e})]
    for m in e2e + layer:
        metric_path(root, m["name"])
    return {"cell": cell, "cfg": cfg, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": layer}


def reports(metric: dict, workload: str) -> bool:
    """An end-to-end metric is reported in every cell, or in its list."""
    return "workloads" not in metric or workload in metric["workloads"]


def reports_layer(metric: dict, workload: str, e2e: set) -> bool:
    """A per-layer metric is reported in the cells it lists, or, without a
    list, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e


def metric_path(root: Path, name: str) -> Path:
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"missing metric reader {path}")
    return path


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(root: Path, name: str, rec: dict) -> Optional[float]:
    mod = load_module(metric_path(root, name),
                      "portbench_metric_" + name.replace(".", "_").replace(
                          "-", "_"))
    value = mod.read(rec)
    if value is None or not math.isfinite(value):
        return None
    return float(value)


def make_driver(files: dict, seed: int, device: torch.device):
    """The driver the mix names: ``drivers/<driver>.py``'s class of the
    same name in CamelCase."""
    name = files["mix"]["driver"]
    mod = importlib.import_module(f"portbench.drivers.{name}")
    cls = getattr(mod, "".join(p.title() for p in name.split("_")))
    return cls(files["cfg"], files["mix"], seed, device)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def bytes_written() -> int:
    """Bytes this process has caused to be written to storage."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except OSError:
        pass
    return 0


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             driver=None) -> Tuple[dict, Dict[str, Tuple[float, float]]]:
    """Run ``workload`` once.  Returns the result line (without its
    ``checks`` key) and the checks: name → (number, limit).  ``driver``
    replaces the driver the mix names (the tests' planted faults)."""
    files = cell_files(root, load_manifest(root), workload)
    if driver is None:
        driver = make_driver(files, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    tracer = DeviceTrace(trace, device)
    t0 = time.perf_counter()
    driver.window(seconds, tracer)
    rec = driver.record()
    rec["setup_s"] = t0 - t_start
    rec["cfg"], rec["mix"] = files["cfg"], files["mix"]
    rec["trace"] = tracer.reduce(rec["spans"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted, failed = driver.attempted(), driver.failed()
    driver.close_program()
    numbers = driver.check()
    limits = files["limits"]
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ManifestError(f"limits/{workload} names {missing}, which "
                            "the driver does not measure")
    checks = {k: (float(numbers[k]), float(v)) for k, v in limits.items()}
    correct = all(v <= lim for v, lim in checks.values()) and failed == 0
    wanted = files["per_layer"] if trace else files["end_to_end"]
    metrics = {}
    for m in wanted:
        value = read_metric(root, m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if rec["trace"] is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = breakdown(rec["trace"])
    result["info"] = {"tokens_cut_share": (
        rec["tokens_cut"] / max(rec["tokens_drawn"], 1)),
        "window_s": rec["window_s"],
        "not_compared": {k: float(v) for k, v in numbers.items()
                         if k not in limits}}
    return result, checks

