"""What the metric readers (``metrics/<name>.py``) share: the window's
steps and launches from a run's record, the work each needs, and device
seconds by kernel from its trace.  A helper returns None where the record
has nothing to read (another kind of cell, an untraced run)."""
from __future__ import annotations

from typing import List, Optional

from portbench.trace import PORT_KERNEL, is_copy, kernel_seconds
from portbench.work import counts, peaks

GS_SWEEP = r"\bgs_loop_kernel\b"
SCHEDULED_SWEEP = r"\bactive::(copy|zero|active_loop)_kernel\b"
THETA_SWEEP = r"\btheta_sweep_(dense|sched|wide)\b"


def steps(rec: dict) -> Optional[List[dict]]:
    return rec.get("steps") or None if rec.get("kind") == "train" else None


def launches(rec: dict) -> Optional[List[dict]]:
    return rec.get("launches") or None if rec.get("kind") == "serve" else None


def mean(xs) -> Optional[float]:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def trace(rec: dict) -> Optional[dict]:
    tr = rec.get("trace")
    return tr if tr and tr["by_op"] else None


def device_seconds(rec: dict, pattern: str) -> Optional[float]:
    tr = trace(rec)
    if tr is None:
        return None
    s = kernel_seconds(tr["by_op"], pattern)
    return s if s > 0 else None


def other_device_seconds(rec: dict) -> Optional[float]:
    """Device seconds of every operation that is neither a port kernel nor
    a copy or fill."""
    tr = trace(rec)
    if tr is None:
        return None
    return sum(s for name, s in tr["by_op"].items()
               if not PORT_KERNEL.search(name) and not is_copy(name))


def idle_percent(rec: dict) -> Optional[float]:
    tr = trace(rec)
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def share(bound_s: float, seconds: Optional[float]) -> Optional[float]:
    """A roofline share in %: the least time over the time taken."""
    if not seconds:
        return None
    return 100.0 * bound_s / seconds


# ------------------------------------------------------------------ train

def sweeps_by_kind(step: dict, cfg: dict):
    """(dense, scheduled, stop-rule checks incl. the warm-up's) of a step."""
    warm = max(1, cfg["warmup_sweeps"])
    total = step["sweeps"]
    dense = total if cfg["active_topics"] == 0 else min(warm, total)
    every = cfg["ppl_check_every"]
    checks = 1 + sum(1 for t in range(warm, total) if (t + 1) % every == 0)
    return dense, total - dense, checks


def dense_work(step: dict, cfg: dict):
    return counts.dense_sweep(step["n"], step["docs"], step["rows"],
                              cfg["num_topics"])


def scheduled_work(step: dict, cfg: dict):
    return counts.scheduled_sweep(step["n"], step["docs"], step["rows"],
                                  cfg["num_topics"], cfg["active_topics"])


def step_work(step: dict, cfg: dict):
    K, A = cfg["num_topics"], cfg["active_topics"]
    n, d, r = step["n"], step["docs"], step["rows"]
    dense, sched, checks = sweeps_by_kind(step, cfg)
    return counts.add(
        counts.step_init(n, d, r, K),
        counts.scale(dense_work(step, cfg), dense),
        counts.scale(scheduled_work(step, cfg), sched),
        counts.scale(counts.scheduler_refresh(r, K, A), sched),
        counts.scale(counts.loglik(n, d, r, K), checks),
        counts.step_end(r, K))


# ------------------------------------------------------------------ serve

def chunk_work(launch: dict, cfg: dict):
    every = cfg["ppl_check_every"]
    return counts.theta_chunk(launch["n"], launch["docs"], launch["rows"],
                              cfg["num_topics"], every)


def chunks(launch: dict, cfg: dict) -> int:
    return launch["sweeps"] // cfg["ppl_check_every"]


def launch_work(launch: dict, cfg: dict):
    K = cfg["num_topics"]
    return counts.add(
        counts.launch_init(launch["n"], launch["docs"], launch["rows"], K),
        counts.scale(chunk_work(launch, cfg), chunks(launch, cfg)),
        counts.launch_end(launch["docs"], K))


def bound(work) -> float:
    return peaks.bound_seconds(*work)
