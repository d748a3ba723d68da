"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (it may
include the shared ``csrc/*.cuh`` headers), compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library and loaded with ``ctypes``; no PyTorch
header is compiled, so a build takes seconds.  The build happens at first
use, on the machine with the card, into ``_build/`` next to this file
(listed in ``.gitignore``); the library's name carries a hash of its source,
the shared headers and the flags, so an edited source is rebuilt.  Nothing
here runs at import time.  Several processes may build at once — the ranks
of a ``launch.mesh.spawn_mesh`` — so :func:`build` holds an exclusive
``fcntl`` lock on ``_build/.lock`` while it looks for and compiles
libraries: the first process builds, the others find the libraries built.

Several threads of one process may launch at once (a thread-backend
replica pool): :func:`load` loads a library and runs its wrapper's ctypes
set-up (``bind``) once, under one lock, and :func:`count_launch` adds to a
wrapper's ``launches`` counter under another, so the counts are exact.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: Every CUDA source of the port, by kernel name.
KERNELS = ("theta_sweep", "gs_sweep", "scheduled_sweep", "sharded_sweep",
           "fused_estep", "topk_estep", "flash_attention",
           "flash_attention_bwd")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Set[Tuple[str, Callable]] = set()
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled on the machine "
        "with the card (CUDA toolkit on PATH or under /usr/local/cuda)"
    )


def library_path(name: str) -> Path:
    """Where the shared library of kernel ``name`` is (or will be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns seconds per kernel built (0.0
    for one already built); raises with the compiler's output on failure.
    The compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes
        return _build_locked(names)


def _build_locked(names: Sequence[str]) -> Dict[str, float]:
    jobs = {}
    out = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            out[name] = 0.0
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so, time.perf_counter())
    for name, (proc, tmp, so, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{log}"
            )
        so.with_name(so.name + ".log").write_text(log)
        os.replace(tmp, so)
        out[name] = time.perf_counter() - t0
    return out


def build_log(name: str) -> str:
    """The compiler's output for kernel ``name`` (empty if not built here)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def loaded() -> Sequence[str]:
    """The kernels whose libraries this process has loaded."""
    with _lock:
        return sorted(_loaded)


def load(name: str,
         bind: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    ``bind(lib)`` — a wrapper's ``argtypes`` / ``restype`` set-up — run on
    it once, before any caller gets it.  Both under one lock: threads that
    call at once wait for the set-up, never see half of it."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            from repro_torch.analysis import launches

            launches.follow(lib, name)
            _loaded[name] = lib
        if bind is not None and (name, bind) not in _bound:
            bind(lib)
            _bound.add((name, bind))
        return lib


def count_launch(wrapper: Callable, n: int = 1) -> None:
    """``wrapper.launches += n`` under a lock, exact when threads launch at
    once (a bare ``+=`` on an attribute is a read, an add and a write, and
    two threads may read the same count)."""
    with _count_lock:
        wrapper.launches += n
