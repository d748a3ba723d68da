"""Dry run of the cells on one card (the PyTorch port of what means
something in torch of ``repro.launch.dryrun``): the paper's LDA cells and
the LM cells, every (arch × shape) of the registry.

For each cell (``launch.specs.build_lda_cell`` / ``build_lm_cell``) it
records, from the meta-device stand-ins and without allocating:

* ``argument_bytes``: the bytes of the cell's arguments (the whole
  model's; one rank's for a sharded LDA cell; for an LM cell also
  ``argument_bytes_per_device``, one device's block under the sharding
  rules on the JAX package's production mesh, 16 × 16 or with
  ``--multi-pod`` 2 × 16 × 16, both with ``--both-meshes``);
* ``working_set_bytes``: what the step holds beside them at its peak, by
  tensor, from the shapes.  An LDA step: the (D, L, K) tensors μ₀, μ, μ_new
  and the eq. 36 residual, and the (W, K) tensors of the FOEM loop at a
  scheduled sweep's residual refresh.  An LM step
  (:func:`lm_working_set_bytes`): its logits, a train step's gradients,
  float32 gradient sums and every layer's saved activations (the port's
  loss checkpoints only its CE chunks), a prefill's output caches and one
  layer's activations.

If the arguments and the working set exceed the card's free memory
(``torch.cuda.mem_get_info``), the record says ``"fits": false`` with
those bytes and the cell is not run.  Otherwise the cell is materialized
from ``--seed`` and one step runs on the card (an LM cell: two, the
second timed).  An LDA record adds the
sweep kernels' build seconds (before the clock starts), the peak allocated
bytes (the largest rank's), the step's seconds, the sweeps run, the
training perplexity, the sweep kernels' launches and the roofline terms
(``launch.roofline``) with the FLOPs and bytes of the sweeps run.  An LM
record adds the peak, the step's seconds, the attention kernels' launches
(forward and backward), finite logits or loss, the ring-cache slots a
decode wrote, the parameters a train step changed, and the roofline terms:
``model_flops_for`` against the bf16 peak and, as HBM bytes, the
parameters and caches read once.  An out-of-memory error in a cell
predicted to fit is raised, not recorded.  Nothing is shrunk: a shape that
does not fit is reported as such.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b \
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --lda stream_1k \
        --impl sharded --ranks 4

Records go to ``build/dryrun/<arch>_<shape>_<impl or mesh>.json``
(``--out``), one ``dryrun {...}`` line each on standard output.  The JAX
package's 256- and 512-device meshes are sized here, not run: a cell runs
only where it fits one card, and a sharded LDA cell runs on
``spawn_mesh``'s ranks.  ``--device cpu`` runs the same on the host (tiny
shapes, for tests): its memory is the host's available memory, and a CPU
run measures no peak (``peak_allocated_bytes`` is None).
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
from repro_torch.launch.specs import ARCH, _leaves, build_lda_cell
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


def run_lda_cell(shape, *, impl: str = "dense", ranks: int = 4,
                 seed: int = 0, active_topics: int = 16,
                 device: Device = "cuda", free_bytes: Optional[int] = None,
                 out_dir: Optional[str] = OUT_DIR,
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
    args_rank = cell.arg_bytes(per_device=True)
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


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------

#: The attention kernels whose launches an LM record counts.
LM_KERNELS = ("flash_attention", "flash_attention_backward")
#: Parameter elements a leaf whose change a train step's record counts
#: (its first elements; a sample, so that no copy of the weights is held).
CHANGE_SAMPLE = 1 << 16


def _attention_counts() -> dict:
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward)

    return {"flash_attention": flash_attention.launches,
            "flash_attention_backward": flash_attention_backward.launches}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _layer_elements(cfg, j: int, tokens: int) -> int:
    """Elements sublayer j of a super-block holds for ``tokens`` tokens:
    its inputs, norms, projections and outputs (a training step saves them
    for backward); an SSM layer adds its chunk states (float32, counted as
    two elements each)."""
    D, F = cfg.d_model, cfg.d_ff
    heads = 2 * cfg.num_heads * cfg.hd
    n = 0
    if cfg.is_attn_layer(j):
        n += tokens * (3 * D + heads + 2 * cfg.num_kv_heads * cfg.hd)
    else:
        din, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        n += tokens * (2 * D + 2 * (2 * din + 2 * ns + nh) + 3 * din)
        n += 2 * -(-tokens // cfg.ssm_chunk) * nh * cfg.ssm_head_dim * ns
    if cfg.is_cross_attn_layer(j):
        n += tokens * (2 * D + heads)
    if cfg.is_moe_layer(j):
        shared = cfg.shared_expert_ff or cfg.d_ff * cfg.num_shared_experts
        n += tokens * (D + 2 * cfg.num_experts
                       + cfg.experts_per_token * (4 * F + D)
                       + (4 * shared if cfg.num_shared_experts else 0))
    elif F > 0:
        n += tokens * (D + 4 * F)
    return n


def lm_working_set_bytes(cell) -> dict:
    """What an LM step holds beside its arguments at its peak, by tensor,
    from the shapes (the whole model's, on one card): an estimate, held
    against the measured peak of every cell that runs."""
    from repro_torch.models.lm import LM

    cfg, shp = cell.cfg, cell.shape
    model = LM(cfg, device="meta")
    params = cell.abstract_args[0]
    el = params["lm_head"].element_size()
    B, S, V, D = shp.global_batch, shp.seq_len, cfg.vocab_size, cfg.d_model
    nb = model.nblocks
    if cell.kind == "train":
        mb = max(1, cfg.micro_batches)
        tokens = B // mb * S
        param_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(params))
        return {
            # every layer's saved activations of one microbatch, and the
            # residual stream
            "activations": el * (nb * sum(
                _layer_elements(cfg, j, tokens) for j in range(model.period))
                + 2 * tokens * D),
            # a CE chunk's float32 logits, their softmax and its gradient
            "logits": 3 * 4 * B // mb * min(512, S) * V,
            "gradients": param_bytes,
            "gradient_sums": 4 * sum(t.numel() for t in _leaves(params))
            if mb > 1 else 0,
        }
    tokens = B * (S if cell.kind == "prefill" else 1)
    one_layer = el * (max(_layer_elements(cfg, j, tokens)
                          for j in range(model.period)) + 2 * tokens * D)
    out = {"activations": one_layer, "logits": el * tokens * V}
    if cell.kind == "prefill":
        # the prompt's caches: full-length K/V (no ring), SSM states/tails
        caches = model.abstract_cache(B, S)
        total = 0
        for j in range(model.period):
            for name, t in caches[f"l{j}"].items():
                if name in ("k", "v"):
                    total += nb * B * cfg.num_kv_heads * S * cfg.hd * el
                else:
                    total += t.numel() * t.element_size()
        out["caches"] = total
    else:
        # a Mamba2 decode's new state before it is copied into the cache
        state = model.abstract_cache(B, 1)
        out["ssm_state"] = max(
            [c["state"][0].numel() * 4 for c in state.values()
             if "state" in c] or [0])
        if 0 < cfg.sliding_window < S:
            # past the window, a layer's ring is rolled into position
            # order: a copy of its K and V (``layers.attention_apply``)
            out["ring_roll"] = (2 * B * cfg.num_kv_heads
                                * cfg.sliding_window * cfg.hd * el)
    return out


def _written_slots(caches) -> list:
    """The sequence slots of the K/V caches that hold a non-zero row, over
    every attention layer and block (one block at a time)."""
    slots = set()
    for layer in caches.values():
        if "k" not in layer:
            continue
        for name in ("k", "v"):
            for blk in layer[name]:
                nz = torch.count_nonzero(blk, dim=(0, 1, 3))
                slots.update(torch.nonzero(nz).flatten().tolist())
    return sorted(slots)


def _named_leaves(tree, path=()):
    """(path, tensor) of each leaf of a dict tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], path + (k,))]
    return [(path, tree)]


#: Steps an LM cell runs: the first (its one-time costs: the kernels'
#: libraries loaded, cuBLAS's first products) and the timed one, on the
#: first one's outputs: a decode rewrites its K/V slot with the same row
#: and advances an SSM state once more, a train step takes a second AdamW
#: step.
LM_STEPS = 2


def _run_lm_step(cell, dev: torch.device, seed: int, opt_count: int
                 ) -> dict:
    import numpy as np

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    args = list(cell.materialize(dev, seed, opt_count=opt_count))
    params = args[0]
    sample = {path: p.detach().reshape(-1)[:CHANGE_SAMPLE].clone()
              for path, p in _named_leaves(params)} \
        if cell.kind == "train" else {}
    times, launches, losses = [], [], []
    for _ in range(LM_STEPS):
        before = _attention_counts()
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = cell.fn(*args)
        if cuda:
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        after = _attention_counts()
        launches.append({k: after[k] - before[k] for k in LM_KERNELS})
        if cell.kind == "train":
            losses.append(float(out[0]))
            args = [out[1], out[2], args[2]]
    rec = {"first_step_s": times[0], "step_s": times[-1],
           "peak_allocated_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                    if cuda else None),
           "launches": launches[-1],
           "launches_all": {k: sum(x[k] for x in launches)
                            for k in LM_KERNELS}}
    if cell.kind == "train":
        changed = {path: int((p.detach().reshape(-1)[:CHANGE_SAMPLE]
                              != sample[path]).sum())
                   for path, p in _named_leaves(out[1])}
        # a matrix: two or more dimensions a layer (the stacked blocks'
        # leading axis aside); the norms' bf16 scales at 1.0 do not move
        # under an update below their half-ulp
        matrices = [path for path, p in _named_leaves(out[1])
                    if p.ndim - ("blocks" in path) >= 2]
        rec.update(loss=losses[0], losses=losses,
                   finite=bool(np.isfinite(losses).all()),
                   opt_count=int(out[2].count),
                   leaves_changed=sum(c > 0 for c in changed.values()),
                   leaves=len(changed),
                   matrices_changed=sum(changed[m] > 0 for m in matrices),
                   matrices=len(matrices),
                   sample_elements_changed=sum(changed.values()))
    else:
        logits, caches = out
        rec.update(finite=bool(torch.isfinite(logits).all()),
                   logits_shape=list(logits.shape),
                   logits_abs_max=float(logits.abs().max()))
        if cell.kind == "decode":
            rec["written_slots"] = _written_slots(caches)
            states = [c["state"] for c in caches.values() if "state" in c]
            rec["ssm_states_written"] = sum(
                int(bool(torch.count_nonzero(b))) for st in states
                for b in st)
    del args, out, params
    if cuda:
        torch.cuda.empty_cache()        # leave the card as it was found
    return rec


def run_lm_cell(arch, shape, *, multi_pod: bool = False,
                both_meshes: bool = False, overrides: Optional[dict] = None,
                seed: int = 0, opt_count: int = 0, device: Device = "cuda",
                free_bytes: Optional[int] = None,
                out_dir: Optional[str] = OUT_DIR,
                verbose: bool = True) -> dict:
    """Dry-run one LM cell and return its record (written to
    ``out_dir/<arch>_<shape>_<mesh>.json`` unless ``out_dir`` is None).
A cell that fits runs ``LM_STEPS`` steps: ``step_s`` and ``launches``
are the last one's, ``first_step_s`` the first's.

    ``arch`` is a registry name or an ``ArchConfig`` (a reduced one on the
    CPU in tests), ``shape`` a name of the arch's shapes or a
    ``ShapeConfig`` (a card shape); ``overrides`` replaces config fields.
    The cell is sized per device on the production mesh (``multi_pod``:
    2 × 16 × 16; ``both_meshes``: both) and whole against the free memory
    (``free_bytes`` replaces it); when it fits, one step runs from
    ``seed``, the optimizer's count at ``opt_count``.
    """
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_lm_cell
    from repro_torch.models.lm import LM

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    meshes = [False, True] if both_meshes else [multi_pod]
    cells = {mesh_name(mp): build_lm_cell(
        arch, shape, make_production_mesh(multi_pod=mp), overrides=overrides)
        for mp in meshes}
    cell = cells[mesh_name(meshes[0])]
    cfg, shp = cell.cfg, cell.shape
    work = lm_working_set_bytes(cell)
    args = cell.arg_bytes()
    predicted = args + sum(work.values())
    free = free_memory(dev) if free_bytes is None else int(free_bytes)
    rec = {
        "arch": cell.arch, "shape": shp.name, "kind": cell.kind,
        "mesh": mesh_name(meshes[0]), "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "dims": {"B": shp.global_batch, "S": shp.seq_len,
                 "layers": cfg.num_layers, "d_model": cfg.d_model,
                 "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                 "micro_batches": cfg.micro_batches},
        "argument_bytes": args,
        "argument_bytes_per_device": {name: c.arg_bytes(per_device=True)
                                      for name, c in cells.items()},
        "working_set_bytes": work,
        "predicted_bytes_on_card": predicted,
        "free_bytes": free,
        "fits": predicted <= free,
        "ran": False, "build_s": None, "peak_allocated_bytes": None,
        "first_step_s": None, "step_s": None, "launches": None,
        "finite": None, "roofline": None,
    }
    if rec["fits"]:
        if dev.type == "cuda":
            # the attention kernels build at their first launch: before
            # the clock
            from repro_torch.kernels import build

            t0 = time.perf_counter()
            build.build(("flash_attention", "flash_attention_bwd"))
            rec["build_s"] = time.perf_counter() - t0
        rec.update(_run_lm_step(cell, dev, seed, opt_count), ran=True)
        model = LM(cfg, device="meta")
        cache_bytes = 0
        if cell.kind == "decode":
            cache_bytes = sum(t.numel() * t.element_size() for t in
                              _leaves(cell.abstract_args[1]))
        elif cell.kind == "prefill":
            cache_bytes = work["caches"]
        param_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(model.abstract_params()))
        peak = (rl.H100_BF16_FLOPS if cfg.dtype == "bfloat16"
                else rl.H100_F32_FLOPS)
        rec["roofline"] = rl.roofline(
            rl.model_flops_for(cfg, shp), param_bytes + cache_bytes,
            peak_flops=peak,
            step_time_s=rec["step_s"] if dev.type == "cuda" else None,
        ).as_dict()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{cell.arch}_{shp.name}_{rec['mesh']}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        print("dryrun " + json.dumps(rec), flush=True)
    return rec


def run_cell(arch, shape, **kwargs) -> dict:
    """Dry-run the cell (``arch``, ``shape``): an LDA cell
    (:func:`run_lda_cell`) when ``arch`` is ``"foem-lda"``, else an LM cell
    (:func:`run_lm_cell`); ``kwargs`` go to that function."""
    if arch == ARCH:
        return run_lda_cell(shape, **kwargs)
    return run_lm_cell(arch, shape, **kwargs)


def iter_all_cells():
    """(arch, shape name) of every cell: each registry arch × its shapes,
    then the LDA shapes."""
    from repro_torch.configs.registry import ARCHS

    for name in sorted(ARCHS):
        for s in ARCHS[name].shapes():
            yield name, s.name
    for s in LDA_SHAPES:
        yield ARCH, s.name


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", help="an LM arch of the registry")
    ap.add_argument("--shape", help="one of the arch's shapes (train_4k, "
                                    "prefill_32k, decode_32k, long_500k)")
    ap.add_argument("--lda", help="the LDA_SHAPES cell to run "
                                  f"({', '.join(s.name for s in LDA_SHAPES)})")
    ap.add_argument("--all", action="store_true",
                    help="run every cell: each arch × shape, then the LDA "
                         "shapes")
    ap.add_argument("--multi-pod", action="store_true",
                    help="size LM cells on the (2, 16, 16) mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="size LM cells on (16, 16) and (2, 16, 16)")
    ap.add_argument("--impl", default="dense", choices=("dense", "sharded"),
                    help="the LDA cells' step")
    ap.add_argument("--ranks", type=int, default=4,
                    help="model ranks of a sharded LDA cell")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--free-bytes", type=int, default=None,
                    help="memory to size the cells against (default: the "
                         "device's free memory)")
    ap.add_argument("--out", default=OUT_DIR, help="record directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.all:
        cells = list(iter_all_cells())
    elif args.lda:
        cells = [(ARCH, args.lda)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("need --arch/--shape, --lda, or --all")
    common = dict(seed=args.seed, device=args.device,
                  free_bytes=args.free_bytes, out_dir=args.out)
    lda = dict(impl=args.impl, ranks=args.ranks)
    lm = dict(multi_pod=args.multi_pod, both_meshes=args.both_meshes)
    return [run_cell(arch, shape, **common, **(lda if arch == ARCH else lm))
            for arch, shape in cells]

if __name__ == "__main__":
    main()
