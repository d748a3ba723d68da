"""Dry run of the paper's LDA cells on one card (the PyTorch port of what
means something in torch of ``repro.launch.dryrun``).

For each cell (``launch.specs.build_lda_cell``) it records, from the
meta-device stand-ins and without allocating:

* ``argument_bytes``: the bytes of the cell's arguments (the whole model's,
  and one rank's for a sharded cell);
* ``working_set_bytes``: what the step holds beside them at its peak, by
  tensor, from the shapes — the (D, L, K) tensors μ₀, μ, μ_new and the
  eq. 36 residual, and the (W, K) tensors of the FOEM loop at a scheduled
  sweep's residual refresh (the minibatch's initial fold, the working φ̂,
  the sweep's new φ̂, the scheduler's residuals, their segment sum, the
  refreshed residuals and two bool masks).

If the arguments and the working set of every rank on the card exceed its
free memory (``torch.cuda.mem_get_info``), the record says ``"fits":
false`` with those bytes and the cell is not run.  Otherwise the cell is
materialized from ``--seed`` and one step runs on the card; the record adds
the seconds of the sweep kernels' build (before the clock starts),
``peak_allocated_bytes`` (``torch.cuda.max_memory_allocated``, the largest
rank's), the step's seconds, the sweeps run, the training perplexity, the
sweep kernels' launches and the roofline terms (``launch.roofline``) with
the FLOPs and bytes of the sweeps actually run.  An out-of-memory error in
a cell predicted to fit is raised, not recorded.  Nothing is shrunk: a
shape that does not fit is reported as such.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --lda stream_1k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --lda stream_1k \\
        --impl sharded --ranks 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Records go to ``build/dryrun/<arch>_<shape>_<impl>.json`` (``--out``), one
``dryrun {...}`` line each on standard output.  The JAX package's 256- and
512-device meshes have no counterpart on one card: a sharded cell runs on
``spawn_mesh``'s ranks.  ``--device cpu`` runs the same on the host (a
tiny shape, for tests): its memory is the host's available memory, and a
CPU run measures no peak (``peak_allocated_bytes`` is None).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs.foem_lda import LDA_SHAPES, LDAShapeConfig, lda_shape
from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import build_lda_cell
from repro_torch.runtime.device import Device, resolve_device

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
#: The kernels whose launches a record counts (``ops.sweep``'s dense and
#: scheduled sweeps, the two-phase engine's probe and fold).
KERNELS = ("gs_sweep", "scheduled_sweep", "sharded_probe", "sharded_fold")


def _kernel_counts() -> dict:
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.kernels.sharded_sweep import sharded_fold, sharded_probe

    return {"gs_sweep": gs_sweep.launches,
            "scheduled_sweep": scheduled_sweep.launches,
            "sharded_probe": sharded_probe.launches,
            "sharded_fold": sharded_fold.launches}


def working_set_bytes(cell, per_rank: bool = True) -> dict:
    """What the step holds beside its arguments at its peak, by tensor,
    from the shapes (a rank's share, or the whole model's): the FOEM loop
    (``foem.foem_minibatch``) at a scheduled sweep's residual refresh
    (``scheduling.scheduler_update_from_sweep``)."""
    _, batch, stats = cell.rank_args() if per_rank else cell.abstract_args
    D, L = batch.word_ids.shape
    W, K = stats.phi_wk.shape
    mu, phi = D * L * K * 4, W * K * 4
    return {
        # (D, L, K) float32: the loop keeps its initial draw; the sweep's
        # input, its output and its eq. 36 residual
        "mu0": mu, "mu": mu, "mu_new": mu, "residual": mu,
        # (W, K) float32: the minibatch's initial fold and the working
        # copy it went into, the sweep's new φ̂, the scheduler's residuals,
        # the refresh's segment sum and its result
        "phi_fold": phi, "phi_work": phi, "phi_new": phi,
        "scheduler_residuals": phi, "scheduler_measured": phi,
        "scheduler_refreshed": phi,
        # (W, K) bool: the refresh's active and touched masks
        "scheduler_masks": 2 * W * K,
    }


def free_memory(device: torch.device) -> int:
    """Free bytes where the cell would run: the card's
    (``mem_get_info`` after emptying the allocator's cache), or the host's
    available memory."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        return int(torch.cuda.mem_get_info(device)[0])
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def _rank_step(mesh, shape, impl, seed, active_topics):
    """Build the cell on this rank, materialize it and run one step; the
    rank's measurements."""
    cell = build_lda_cell(shape, mesh, impl=impl,
                          active_topics=active_topics)
    return _run_step(cell, mesh.device, seed)


def _run_step(cell, dev: torch.device, seed: int) -> dict:
    cuda = dev.type == "cuda"
    before = _kernel_counts()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    key, batch, stats = cell.materialize(dev, seed)
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    new_stats, ppl, sweeps = cell.fn(key, batch, stats)
    if cuda:
        torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    after = _kernel_counts()
    out = {"step_s": step_s, "sweeps": int(sweeps), "train_ppl": float(ppl),
           "peak_allocated_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                    if cuda else None),
           "tokens": float(batch.counts.sum()),
           "phi_k_mass": float(new_stats.phi_k.double().sum()),
           "launches": {k: after[k] - before[k] for k in KERNELS}}
    del key, batch, stats, new_stats
    if cuda:
        torch.cuda.empty_cache()        # leave the card as it was found
    return out


def _sizing_mesh(ranks: int, device: torch.device):
    """A (1, ranks) mesh description for sizing a sharded cell before the
    ranks exist (rank 0's coordinates, no process group)."""
    from repro_torch.launch.mesh import Mesh, MeshAxis

    return Mesh(MeshAxis("data", 1, 0), MeshAxis("model", ranks, 0), device)


@contextlib.contextmanager
def _expandable_segments(device: torch.device):
    """Start CUDA ranks with the caching allocator's expandable segments
    (unless the caller set ``PYTORCH_CUDA_ALLOC_CONF``): ranks that share
    one card otherwise each keep gigabytes reserved but unallocated, and a
    stream_1k cell of four ranks that fits by its allocations ran out of
    memory on an 80 GB H100."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    set_here = device.type == "cuda" and key not in os.environ
    if set_here:
        os.environ[key] = "expandable_segments:True"
    try:
        yield
    finally:
        if set_here:
            del os.environ[key]


def run_cell(shape, *, impl: str = "dense", ranks: int = 4, seed: int = 0,
             active_topics: int = 16, device: Device = "cuda",
             free_bytes: Optional[int] = None, out_dir: Optional[str] = OUT_DIR,
             verbose: bool = True) -> dict:
    """Dry-run one LDA cell and return its record (written to
    ``out_dir/<arch>_<shape>_<impl>.json`` unless ``out_dir`` is None).

    ``shape`` is an ``LDA_SHAPES`` name or an ``LDAShapeConfig`` (a tiny
    one on the CPU in tests).  ``impl="sharded"`` runs ``ranks`` model
    ranks of ``spawn_mesh`` (sharing the card over gloo, or a card each
    over NCCL).  ``free_bytes`` replaces the measured free memory.
    """
    shp = shape if isinstance(shape, LDAShapeConfig) else lda_shape(shape)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sharded = impl == "sharded"
    n_ranks = ranks if sharded else 1
    cell = build_lda_cell(shp, _sizing_mesh(ranks, dev) if sharded else None,
                          impl=impl, active_topics=active_topics)
    # ranks sharing one card (gloo) all count against its memory
    cards = (n_ranks if dev.type == "cuda"
             and torch.cuda.device_count() >= n_ranks and sharded else 1)
    on_card = n_ranks // cards
    args_rank = cell.arg_bytes(per_rank=True)
    work = working_set_bytes(cell)
    predicted = on_card * (args_rank + sum(work.values()))
    free = free_memory(dev) if free_bytes is None else int(free_bytes)
    rec = {
        "arch": cell.arch, "shape": shp.name, "kind": cell.kind,
        "impl": impl, "ranks": n_ranks, "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "dims": {"D": shp.minibatch_docs, "L": shp.bucket_len,
                 "K": shp.num_topics, "W": shp.vocab_size,
                 "A": cell.cfg.active_topics},
        "argument_bytes": cell.arg_bytes(),
        "argument_bytes_per_rank": args_rank,
        "working_set_bytes": work,
        "predicted_bytes_on_card": predicted,
        "free_bytes": free,
        "fits": predicted <= free,
        "ran": False, "build_s": None,
        "peak_allocated_bytes": None, "step_s": None, "step_s_by_rank": None,
        "sweeps": None, "train_ppl": None, "tokens": None,
        "phi_k_mass": None, "launches": None, "roofline": None,
    }
    if rec["fits"]:
        if dev.type == "cuda":
            # the sweep kernels build at their first launch: before the
            # clock, so that the step's seconds are the step's
            from repro_torch.kernels import build

            t0 = time.perf_counter()
            build.build(("gs_sweep", "scheduled_sweep", "sharded_sweep"))
            rec["build_s"] = time.perf_counter() - t0
        if sharded:
            from repro_torch.launch.mesh import spawn_mesh

            with _expandable_segments(dev):
                outs = spawn_mesh(_rank_step, 1, ranks, device=dev,
                                  args=(shp, impl, seed, active_topics))
        else:
            outs = [_run_step(cell, dev, seed)]
        first = outs[0]
        peaks = [o["peak_allocated_bytes"] for o in outs]
        step_s = max(o["step_s"] for o in outs)
        flops = rl.lda_model_flops(shp, sweeps=first["sweeps"],
                                   active_topics=cell.cfg.active_topics)
        nbytes = rl.lda_step_bytes(shp, first["sweeps"])
        rec.update(
            ran=True,
            peak_allocated_bytes=None if None in peaks else max(peaks),
            step_s=step_s,
            step_s_by_rank=[o["step_s"] for o in outs],
            sweeps=first["sweeps"], train_ppl=first["train_ppl"],
            tokens=first["tokens"],
            phi_k_mass=math.fsum(o["phi_k_mass"] for o in outs),
            launches={k: sum(o["launches"][k] for o in outs)
                      for k in KERNELS},
            # the terms are the card's; a host run's seconds are not set
            # against them
            roofline=rl.roofline(
                flops / cards, nbytes / cards,
                step_time_s=step_s if dev.type == "cuda" else None,
            ).as_dict())
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{cell.arch}_{shp.name}_{impl}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        print("dryrun " + json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lda", help="the LDA_SHAPES cell to run "
                                  f"({', '.join(s.name for s in LDA_SHAPES)})")
    ap.add_argument("--all", action="store_true",
                    help="run every LDA_SHAPES cell")
    ap.add_argument("--impl", default="dense", choices=("dense", "sharded"))
    ap.add_argument("--ranks", type=int, default=4,
                    help="model ranks of a sharded cell")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--free-bytes", type=int, default=None,
                    help="memory to size the cells against (default: the "
                         "device's free memory)")
    ap.add_argument("--out", default=OUT_DIR, help="record directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if bool(args.lda) == args.all:
        ap.error("pass exactly one of --lda SHAPE and --all")
    shapes = [s.name for s in LDA_SHAPES] if args.all else [args.lda]
    return [run_cell(s, impl=args.impl, ranks=args.ranks, seed=args.seed,
                     device=args.device, free_bytes=args.free_bytes,
                     out_dir=args.out)
            for s in shapes]


if __name__ == "__main__":
    main()
