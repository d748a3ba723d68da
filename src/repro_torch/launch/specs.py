"""The paper's LDA cells: one FOEM step per ``LDA_SHAPES`` regime (PyTorch
port of the LDA half of ``repro.launch.specs``).

A :class:`Cell` packages a step function with its arguments as
**meta-device stand-ins** (the counterpart of the JAX package's
``ShapeDtypeStruct`` abstract arguments): building a cell allocates
nothing, so the dry run (``launch.dryrun``) can size any regime — bigmodel's
100 GB φ̂ included — before it decides to run it.  ``Cell.materialize``
turns the stand-ins into real tensors on a device.

* ``impl="dense"`` is the JAX package's ``"pjit"`` cell: ``core.foem.
  foem_step`` on the whole φ̂, on one device.
* ``impl="sharded"`` is ``core.foem_sharded.foem_step_sharded`` over a
  ``launch.mesh.Mesh`` (``cfg.topk_shards`` = the model axis size): every
  rank builds the cell with its own mesh and holds its slice of the
  arguments (:attr:`Cell.slice_specs`).

The LM half (``build_lm_cell``, ``input_specs``) waits for the LM stack
(ROADMAP queue 1 item 10.8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.foem_lda import LDAShapeConfig, lda_config, lda_shape
from repro_torch.core.types import GlobalStats, LDAConfig, MinibatchData
from repro_torch.runtime.device import Device, resolve_device

ARCH = "foem-lda"
IMPLS = ("dense", "sharded")
#: The stand-in of the step's random key: two uint32 words of a 64-bit
#: seed, the JAX package's (2,) uint32 PRNG key.
KEY_SHAPE, KEY_DTYPE = (2,), torch.uint32


@dataclasses.dataclass
class Cell:
    """One LDA cell: a step function and its arguments as stand-ins.

    ``fn(key, batch, stats)`` runs one FOEM step and returns ``(new_stats,
    train_ppl, sweeps)``.  ``abstract_args`` are the whole-model arguments
    on the meta device, with the JAX cell's shapes and dtypes: the (2,)
    uint32 key, the (D_s, L) int32 word ids and float32 counts, and
    ``GlobalStats`` (φ̂ (W, K), φ̂(k) (K,), the int32 step).
    ``slice_specs`` mirrors them: for each tensor the mesh axis that splits
    each of its dimensions (``None``: not split), as the JAX cell's
    ``in_shardings`` — a sharded cell's φ̂ (W, K/mp) and φ̂(k) (K/mp,) are a
    rank's topic slice (``foem_sharded.shard_stats``) and its word ids and
    counts its document rows.  ``donate_argnums``: the stats are the step's
    donated state (the caller keeps only the returned stats).
    """

    arch: str
    shape: LDAShapeConfig
    kind: str                      # "lda"
    impl: str                      # "dense" | "sharded"
    cfg: LDAConfig
    fn: Callable
    abstract_args: Tuple[Any, ...]
    slice_specs: Tuple[Any, ...]
    mesh: Any = None               # launch.mesh.Mesh of a sharded cell
    donate_argnums: Tuple[int, ...] = (2,)

    def rank_args(self) -> Tuple[Any, ...]:
        """The stand-ins of the arguments one rank holds (its slice under
        :attr:`slice_specs` at its mesh coordinates; the whole arguments for
        a dense cell), on the meta device."""
        key, batch, stats = self.abstract_args
        _, batch_specs, stats_specs = self.slice_specs
        return (key, MinibatchData(*map(self._slice, batch, batch_specs)),
                GlobalStats(*map(self._slice, stats, stats_specs)))

    def arg_bytes(self, per_rank: bool = False) -> int:
        """Bytes of the arguments: the whole model's, or one rank's."""
        key, batch, stats = (self.rank_args() if per_rank
                             else self.abstract_args)
        return sum(t.numel() * t.element_size()
                   for t in (key, *batch, *stats))

    def _slice(self, t: torch.Tensor, spec) -> torch.Tensor:
        """``t``'s block at this rank's mesh coordinates under ``spec``."""
        if self.mesh is None:
            return t
        index = []
        for n, name in zip(t.shape, spec):
            axis = getattr(self.mesh, name) if name else None
            index.append(slice(None) if axis is None else slice(
                axis.index * n // axis.size,
                (axis.index + 1) * n // axis.size))
        return t[tuple(index)]

    def materialize(self, device: Device = "cuda", seed: int = 0
                    ) -> Tuple[Any, ...]:
        """This rank's arguments as real tensors on ``device`` (default
        ``"cuda"``): the key from ``seed``, the minibatch drawn by numpy
        from ``seed`` (:func:`cell_minibatch`, sliced to the rank's rows)
        and zero statistics of the rank's slice — the JAX cell's
        ``GlobalStats.zeros``, the first step of a stream."""
        dev = resolve_device(device)
        key = torch.tensor(seed_key(seed), dtype=KEY_DTYPE)
        wid, cnt = cell_minibatch(self.shape, seed)
        batch_specs = self.slice_specs[1]
        batch = MinibatchData(*(
            self._slice(torch.from_numpy(x), spec).contiguous().to(dev)
            for x, spec in zip((wid, cnt), batch_specs)))
        stats = GlobalStats(*(torch.zeros(s.shape, dtype=s.dtype, device=dev)
                              for s in self.rank_args()[2]))
        return key, batch, stats


def seed_key(seed: int) -> Tuple[int, int]:
    """The (2,) uint32 words of a 64-bit ``seed``, high word first (the
    layout of ``jax.random.PRNGKey``)."""
    seed = int(seed) % 2 ** 64
    return seed >> 32, seed & 0xFFFFFFFF


def key_generator(key: torch.Tensor, device) -> torch.Generator:
    """A generator on ``device`` seeded from a (2,) uint32 key."""
    hi, lo = (int(x) for x in key.tolist())
    return torch.Generator(device=device).manual_seed((hi << 32) | lo)


def cell_minibatch(shape: LDAShapeConfig, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One (D_s, L) bucketed minibatch of the cell, drawn by numpy from
    ``seed``: ``TrafficGenerator``'s Zipf(1.1) documents over the W-word
    vocabulary, L/2 to 2L tokens each, each document's L highest-count
    words kept (``sparse.docword.bucketize``)."""
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse.docword import bucketize

    L = shape.bucket_len
    gen = TrafficGenerator(shape.vocab_size, doc_len=(max(1, L // 2), 2 * L),
                           seed=seed)
    corpus = gen.corpus(shape.minibatch_docs)
    return bucketize(corpus, range(shape.minibatch_docs), bucket_len=L)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_lda_cell(
    shape_name, mesh=None, *,
    shard_topics: bool = True, active_topics: int = 16,
    overrides: Optional[dict] = None, impl: str = "dense",
) -> Cell:
    """The cell of one ``LDA_SHAPES`` regime (``shape_name``, or an
    ``LDAShapeConfig`` such as a tiny test shape).

    ``impl="dense"`` (the JAX ``"pjit"`` cell) steps the whole φ̂ with
    ``foem.foem_step`` on the device the arguments lie on; ``mesh`` is
    ignored.  ``impl="sharded"`` steps a rank's topic slice with
    ``foem_step_sharded`` over ``mesh`` (a ``launch.mesh.Mesh``: its
    ``model`` axis splits K, its ``data`` axis the documents), with
    ``cfg.topk_shards`` = ``mesh.model.size``; the port shards topics only,
    so ``shard_topics=False`` raises ``ValueError``.  ``overrides``
    replaces ``LDAConfig`` fields after ``lda_config(shape,
    active_topics)``.  Allocates nothing.
    """
    shp = (shape_name if isinstance(shape_name, LDAShapeConfig)
           else lda_shape(shape_name))
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    cfg = lda_config(shp, active_topics=active_topics)
    overrides = dict(overrides or {})
    if impl == "sharded":
        if mesh is None:
            raise ValueError("a sharded cell needs the rank's mesh")
        if not shard_topics:
            raise ValueError("the port's sharded step shards topics "
                             "(shard_topics=True)")
        overrides.setdefault("topk_shards", mesh.model.size)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    D, L = shp.minibatch_docs, shp.bucket_len
    batch_abs = MinibatchData(word_ids=_meta((D, L), torch.int32),
                              counts=_meta((D, L), torch.float32))
    stats_abs = GlobalStats(phi_wk=_meta((cfg.W, cfg.K), cfg.dtype),
                            phi_k=_meta((cfg.K,), cfg.dtype),
                            step=_meta((), torch.int32))
    key_abs = _meta(KEY_SHAPE, KEY_DTYPE)

    if impl == "sharded":
        from repro_torch.core.foem_sharded import foem_step_sharded

        specs = ((None,),
                 MinibatchData(("data", None), ("data", None)),
                 GlobalStats((None, "model"), ("model",), ()))

        def lda_step(key, batch, stats):
            # a host generator: the step folds the rank's model index into
            # one host draw from it (foem_sharded._fold_in)
            return foem_step_sharded(key_generator(key, "cpu"), batch,
                                     stats, cfg, mesh)
    else:
        from repro_torch.core.foem import foem_step

        specs = ((None,), MinibatchData((None, None), (None, None)),
                 GlobalStats((None, None), (None,), ()))
        mesh = None

        def lda_step(key, batch, stats):
            dev = stats.phi_wk.device
            new, _, diag = foem_step(key_generator(key, dev), batch, stats,
                                     cfg, device=dev)
            return new, diag.final_train_ppl, diag.sweeps_run

    return Cell(arch=ARCH, shape=shp, kind="lda", impl=impl, cfg=cfg,
                fn=lda_step, abstract_args=(key_abs, batch_abs, stats_abs),
                slice_specs=specs, mesh=mesh)
