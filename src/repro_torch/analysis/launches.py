"""The launches the kernel wrappers make, noted as contract instances.

While :func:`enabled`, every wrapper that launches a contracted kernel
notes which library launched it, the contract's name, the
:class:`~repro_torch.analysis.budget.Cell` and the options its C entry
chose (the variant's 16-byte path, the wide state, the E-step's
exclusion…): one dict update a launch.  ``analysis.card`` rebuilds each
noted launch's :class:`LaunchSpec` with the card's registers and holds it
against the library's own launch records (``csrc/launch_log.cuh``), which
:func:`enable` switches on and off with the notes, in every library loaded
then or later.  Off by default: a server that is not being checked keeps
no notes and no records.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Tuple

from repro_torch.analysis.budget import Cell

_lock = threading.Lock()
_on = False
_notes: Dict[Tuple, int] = {}


def enable(on: bool = True) -> None:
    """Start (or stop) noting launches, and the loaded kernel libraries'
    launch records with them."""
    global _on
    _on = on
    from repro_torch.kernels import build

    for name in build.loaded():
        follow(build.load(name), name)


def follow(lib: ctypes.CDLL, name: str) -> None:
    """Switch library ``name``'s launch records (``LIB_launch_enable``) to
    :func:`enabled`; ``kernels.build.load`` calls it on every library it
    loads."""
    fn = getattr(lib, f"{name}_launch_enable")
    fn.argtypes, fn.restype = [ctypes.c_int], None
    fn(int(_on))


def enabled() -> bool:
    return _on


def clear() -> None:
    with _lock:
        _notes.clear()


def note(library: str, contract: str, cell: Cell, **opts) -> None:
    """Note one launch of ``contract`` by ``library`` at ``cell``."""
    if not _on:
        return
    key = (library, contract, cell, tuple(sorted(opts.items())))
    with _lock:
        _notes[key] = _notes.get(key, 0) + 1


def notes() -> List[Tuple[str, str, Cell, Dict, int]]:
    """``(library, contract, cell, options, launches)`` of every distinct
    launch noted."""
    with _lock:
        return [(lib, name, cell, dict(opts), n)
                for (lib, name, cell, opts), n in _notes.items()]
