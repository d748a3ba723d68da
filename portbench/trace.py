"""The device trace of a ``--trace 1`` window, and its reduction.

``torch.profiler`` records the CUDA activity of every thread of the
process (kernels, copies, fills) between :meth:`DeviceTrace.start` and
:meth:`DeviceTrace.stop`.  :meth:`DeviceTrace.reduce` turns it into

* ``busy_s``: the union of the device operations' intervals;
* ``by_op``: device seconds by operation name;
* ``gaps``: the longest idle gaps between busy intervals, each labelled
  with the innermost host span (the drivers' own, around their calls into
  each layer) that covers the gap's middle.

Host spans are on ``time.perf_counter``; the trace has its own clock.  A
marker kernel (``torch.cuda._sleep``), launched right after a host
timestamp on an idle device, ties the two together to within its launch
latency.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: The port's CUDA kernels (the ``__global__`` functions of
#: ``repro_torch/kernels/csrc``), as the profiler names them.
PORT_KERNEL = re.compile(
    r"\b(gs_loop_kernel|active::(copy|zero|active_loop)_kernel|"
    r"sweep_loglik_kernel|theta_sweep_(dense|sched|wide)|"
    r"fused_estep_(regs|two_pass)|topk_(estep|loop)_kernel|"
    r"probe_(dense|sched)_kernel|dense_loop_kernel|loglik_u_kernel|"
    r"flash_attention\w*)\b")
MARKER = re.compile(r"spin_kernel|sleep", re.IGNORECASE)
MARKER_CYCLES = 20_000
#: idle gaps labelled and kept, longest first
GAPS_KEPT = 10

Span = Tuple[str, float, float]       # (name, host start, host end)


def is_copy(name: str) -> bool:
    """A copy or fill between or within memories, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def _kineto_events(prof) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, name) of every device event, on the trace's
    clock."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:         # no raw results: the parsed events
        return [(e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.device_type == cuda]
    for e in results.events():
        if e.device_type() != cuda:
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            s, d = float(e.start_us()), float(e.duration_us())
        out.append((s, s + d, e.name()))
    return out


class DeviceTrace:
    """A profiled window; a no-op when ``enabled`` is false."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = bool(enabled) and device.type == "cuda"
        self.device = device
        self.prof = None
        self.t_start = self.t_stop = 0.0
        self.t_marker = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_marker = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize(self.device)
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if not self.enabled or self.prof is None:
            return
        torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self, spans: Sequence[Span]) -> Optional[Dict]:
        """``busy_s``, ``window_s``, ``by_op`` and the labelled ``gaps``
        (longest first), or None when nothing was traced."""
        if not self.enabled or self.prof is None:
            return None
        events = _kineto_events(self.prof)
        marker = [e for e in events if MARKER.search(e[2])]
        events = [e for e in events if not MARKER.search(e[2])]
        if not events:
            return {"busy_s": 0.0, "window_s": self.t_stop - self.t_start,
                    "by_op": {}, "gaps": []}
        # host time t sits at trace time (t − t_marker)·1e6 + origin
        origin = (marker[0][0] if marker
                  else min(e[0] for e in events))
        lo = origin + (self.t_start - self.t_marker) * 1e6
        hi = origin + (self.t_stop - self.t_marker) * 1e6
        by_op: Dict[str, float] = {}
        merged: List[List[float]] = []
        for s, e, name in sorted(events):
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) / 1e6
        host = [(n, origin + (a - self.t_marker) * 1e6,
                 origin + (b - self.t_marker) * 1e6) for n, a, b in spans]
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        idle = sorted(((b - a, a, b) for a, b in zip(edges[0::2],
                                                     edges[1::2])
                       if b > a), reverse=True)[:GAPS_KEPT]
        gaps = []
        for length, a, b in idle:
            mid = (a + b) / 2
            cover = [(y - x, n) for n, x, y in host if x <= mid <= y]
            gaps.append((min(cover)[1] if cover else "no span",
                         length / 1e6))
        return {"busy_s": busy, "window_s": self.t_stop - self.t_start,
                "by_op": by_op, "gaps": gaps}


def kernel_seconds(by_op: Dict[str, float], pattern: str) -> float:
    """Device seconds of the operations whose names match ``pattern``."""
    rx = re.compile(pattern)
    return sum(s for name, s in by_op.items() if rx.search(name))


def breakdown(reduced: Dict, n: int = 10) -> Dict:
    """The ``breakdown`` of a traced result line: the ``n`` device
    operations that took most time (names cut to 120 characters, equal cut
    names summed) and the ``n`` longest idle gaps."""
    ops: Dict[str, float] = {}
    for name, s in reduced["by_op"].items():
        ops[name[:120]] = ops.get(name[:120], 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in reduced["gaps"][:n]]}
