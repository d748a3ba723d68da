"""Atomic, crash-consistent pytree checkpoints (PyTorch port of
``repro.checkpoint.ckpt``, in the same on-disk format).

Layout:  <dir>/step_<n>/
            manifest.json     — tree structure, shapes, dtypes, per-leaf crc32
            <leaf-index>.npy  — one file per leaf (streamable, partial-readable)
         <dir>/LATEST         — atomically-replaced pointer file

Write protocol: write into ``step_<n>.tmp`` (every leaf and the manifest
fsync'd), rename the directory — the commit point — then replace LATEST;
directory fsyncs order the renames against power loss.  A crash (or a
seeded ``kill`` fault — the chaos suite SIGKILLs at both injected
boundaries) at any point leaves either the old or the new checkpoint valid,
never a torn one: :func:`scan_checkpoints` on restart removes stale
``.tmp`` debris, validates manifests + leaf checksums, and repairs a
missing or dangling LATEST pointer to the newest intact checkpoint.

Leaf order is the JAX package's (:func:`tree_flatten`: dict keys sorted,
lists, tuples, named tuples and dataclasses in field order, ``None`` an
empty node), so a checkpoint written by either package restores leaf for
leaf in the other; tensors are copied to the host before writing.  A leaf's
crc32 is taken over its ``.npy`` file in 64 MiB chunks, which gives the
value the JAX package computes over the whole file at once without holding
a 5.64 GB leaf in memory twice.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import faults as fault_lib

_CRC_CHUNK = 64 << 20        # bytes a crc32 read
_END = object()


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed validation (torn write / external damage)."""


# ---------------------------------------------------------------------------
# pytrees in the JAX package's leaf order
# ---------------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[Tuple[str, list, Callable]]:
    """``(label, children, rebuild)`` of a container node, ``None`` for a
    leaf.  ``rebuild(children)`` makes a node of ``node``'s type."""
    if isinstance(node, collections.OrderedDict):
        keys = list(node)
        return (f"OrderedDict{keys}", [node[k] for k in keys],
                lambda ch: collections.OrderedDict(zip(keys, ch)))
    if isinstance(node, dict):
        keys = sorted(node)
        return (f"dict{keys}", [node[k] for k in keys],
                lambda ch: type(node)(zip(keys, ch))
                if type(node) is dict else dict(zip(keys, ch)))
    if _is_namedtuple(node):
        return (f"namedtuple[{type(node).__name__}]", list(node),
                lambda ch: type(node)(*ch))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, list(node),
                lambda ch: type(node)(ch))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return (f"dataclass[{type(node).__name__}]",
                [getattr(node, n) for n in names],
                lambda ch: dataclasses.replace(node, **dict(zip(names, ch))))
    return None


def tree_flatten(tree) -> Tuple[list, str]:
    """``(leaves, structure)`` of ``tree`` in ``jax.tree.flatten``'s order.

    Containers are dicts (keys sorted; an ``OrderedDict`` in its own
    order), lists, tuples, named tuples and dataclasses (fields in order);
    ``None`` holds no leaf; anything else is a leaf.  ``structure``
    describes the tree for the manifest (it need not equal the JAX
    package's string: restores take their structure from ``like``)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


# The walks below are module functions, not closures: a closure that calls
# itself is a reference cycle, which would keep every leaf it saw (a
# model's parameters, gradients or moments) alive until the cyclic
# collector runs.

def _flatten(node, leaves: list) -> str:
    if node is None:
        return "None"
    got = _children(node)
    if got is None:
        leaves.append(node)
        return "*"
    label, children, _ = got
    return f"{label}({', '.join(_flatten(c, leaves) for c in children)})"


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves`` (the inverse of :func:`tree_flatten`)."""
    it = iter(leaves)
    out = _unflatten(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def _unflatten(node, it):
    if node is None:
        return None
    got = _children(node)
    if got is None:
        return next(it)
    _, children, rebuild = got
    return rebuild([_unflatten(c, it) for c in children])


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching nodes of the
    trees in ``rest``, which must share ``tree``'s structure down to its
    leaves, where they may hold anything), in ``tree``'s structure."""
    leaves, _ = tree_flatten(tree)
    others = [_leaves_like(tree, r) for r in rest]
    return tree_unflatten(tree, [fn(x, *ys) for x, *ys in
                                 zip(leaves, *others)])


def _leaves_like(tree, other) -> list:
    """The nodes of ``other`` at the positions of ``tree``'s leaves."""
    out: list = []
    _like(tree, other, out)
    return out


def _like(node, o, out: list) -> None:
    if node is None:
        return
    got = _children(node)
    if got is None:
        out.append(o)
        return
    _, children, _ = got
    ogot = _children(o)
    if ogot is None or len(ogot[1]) != len(children):
        raise ValueError(f"tree structures differ at {o!r}")
    for c, oc in zip(children, ogot[1]):
        _like(c, oc, out)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype here; "
                            "checkpoint them as float32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# the write protocol
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def file_crc32(path: str) -> int:
    """zlib crc32 of a file's bytes, read in chunks."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _save_npy_synced(path: str, arr: np.ndarray) -> int:
    """np.save + fsync; returns the file's crc32 (the manifest fingerprint)."""
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    return file_crc32(path)


def save_checkpoint(
    path: str,
    step: int,
    tree: Any,
    *,
    keep: int = 3,
    faults: Optional[fault_lib.FaultPlan] = None,
) -> str:
    """Atomically persist ``tree`` as ``step_<n>``.

    ``faults`` fires ``mid-flush`` after the shadow directory is fully
    written but *before* the commit rename (kill → old checkpoint stands)
    and ``pre-publish`` after the commit but before LATEST moves (kill →
    new checkpoint exists; the recovery scan repairs the pointer).
    """
    leaves, treedef = tree_flatten(tree)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "num_leaves": len(leaves),
                "treedef": treedef, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _to_host(leaf)
        crc = _save_npy_synced(os.path.join(tmp, f"{i}.npy"), arr)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": str(arr.dtype), "crc": crc}
        )
        del arr
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if faults is not None:
        faults.fire(fault_lib.MID_FLUSH, step=step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # ---- COMMIT ----
    _fsync_dir(path)
    if faults is not None:
        faults.fire(fault_lib.PRE_PUBLISH, step=step)
    latest_tmp = os.path.join(path, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(path, "LATEST"))
    _fsync_dir(path)
    _gc(path, keep)
    return final


def _gc(path: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(path)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def _validate(d: str) -> bool:
    """Is ``step_<n>`` intact? (manifest readable, every leaf present with
    a matching checksum — pre-crc checkpoints validate by presence only)."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    for i, spec in enumerate(manifest.get("leaves", [])):
        p = os.path.join(d, f"{i}.npy")
        if not os.path.exists(p):
            return False
        crc = spec.get("crc")
        if crc is not None and file_crc32(p) != crc:
            return False
    return True


def scan_checkpoints(path: str) -> List[int]:
    """Recovery scan: drop ``.tmp`` debris, validate every checkpoint, and
    repair a missing/dangling LATEST.  Returns the valid steps (ascending).

    Idempotent and safe to run on every open — the restart half of the
    crash-consistency contract.
    """
    if not os.path.isdir(path):
        return []
    valid: List[int] = []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".tmp"):                # uncommitted shadow
            (shutil.rmtree if os.path.isdir(full) else os.unlink)(full)
            continue
        if not name.startswith("step_"):
            continue
        if _validate(full):
            valid.append(int(name.split("_")[1]))
        else:
            shutil.rmtree(full, ignore_errors=True)   # torn: unusable
    latest = os.path.join(path, "LATEST")
    pointed: Optional[int] = None
    if os.path.exists(latest):
        with open(latest) as f:
            name = f.read().strip()
        if name.startswith("step_") and int(name.split("_")[1]) in valid:
            pointed = int(name.split("_")[1])
    if valid and pointed != valid[-1]:
        tmp = latest + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"step_{valid[-1]:08d}")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, latest)
    elif not valid and os.path.exists(latest):
        os.unlink(latest)                        # dangling pointer
    return valid


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    return int(name.split("_")[1])


def restore_checkpoint(path: str, like: Any, *, step: Optional[int] = None
                       ) -> Tuple[int, Any]:
    """Restore host numpy arrays into the structure of ``like``
    (``elastic.restore_resharded`` places them on a mesh).

    Runs the recovery scan first, so a restart right after a crash (torn
    directory, stale LATEST) restores the newest *intact* checkpoint.  A
    checkpoint whose leaf count differs from ``like``'s raises
    ``ValueError``.
    """
    valid = scan_checkpoints(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    elif step not in valid:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} under {path} is missing or torn"
        )
    d = os.path.join(path, f"step_{step:08d}")
    leaves, _ = tree_flatten(like)
    with open(os.path.join(d, "manifest.json")) as f:
        stored = json.load(f).get("num_leaves", len(leaves))
    if stored != len(leaves):
        raise ValueError(f"checkpoint step {step} holds {stored} leaves, "
                         f"the tree to restore into {len(leaves)}")
    out = [np.load(os.path.join(d, f"{i}.npy")) for i in range(len(leaves))]
    return step, tree_unflatten(like, out)
