"""The dry run's cells (PyTorch port of ``repro.launch.specs``): the
paper's LDA cells, one FOEM step per ``LDA_SHAPES`` regime, and the LM
cells, one train, prefill or decode step per (arch × shape).

A :class:`Cell` (an :class:`LDACell` or an :class:`LMCell`) packages a
step function with its arguments as **meta-device stand-ins** (the
counterpart of the JAX package's ``ShapeDtypeStruct`` abstract
arguments): building a cell allocates nothing, so the dry run
(``launch.dryrun``) can size any regime — bigmodel's 100 GB φ̂ included —
before it decides to run it.  A cell's ``materialize`` turns the
stand-ins into real tensors on a device.

* ``impl="dense"`` is the JAX package's ``"pjit"`` cell: ``core.foem.
  foem_step`` on the whole φ̂, on one device.
* ``impl="sharded"`` is ``core.foem_sharded.foem_step_sharded`` over a
  ``launch.mesh.Mesh`` (``cfg.topk_shards`` = the model axis size): every
  rank builds the cell with its own mesh and holds its slice of the
  arguments (:attr:`Cell.slice_specs`, :meth:`LDACell.rank_args`).

The LM half: ``lm_input_specs`` / ``input_specs`` are a cell's model
inputs as stand-ins, and ``build_lm_cell`` an :class:`LMCell`, whose
``slice_specs`` are the sharding rules' (``parallel.sharding``) on the
cell's mesh — the production meshes as ``launch.mesh.AbstractMesh``
descriptions, where the dry run sizes a cell per device.  The rules read
the config's ``fsdp``, ``tp_size`` and ``moe_impl``, the moments' specs
its ``zero1``; the train step reads ``micro_batches``.  The LM modules are
imported inside the functions that use them: the LDA cells never load the
LM stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import tree_flatten, tree_map, tree_unflatten
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
    """One cell: a step function and its arguments as stand-ins.

    ``abstract_args`` are the whole model's arguments on the meta device,
    with the JAX cell's shapes and dtypes.  ``slice_specs`` mirrors them:
    at each tensor, its spec (``parallel.sharding``: for each dimension
    ``None`` or the mesh axes that split it), as the JAX cell's
    ``in_shardings``.  ``donate_argnums``: the arguments the step updates
    in place (the caller keeps only what it returns).
    """

    arch: str
    shape: Any
    kind: str
    cfg: Any
    fn: Callable
    abstract_args: Tuple[Any, ...]
    slice_specs: Tuple[Any, ...]
    mesh: Any = None
    donate_argnums: Tuple[int, ...] = ()

    def arg_bytes(self, per_device: bool = False) -> int:
        """Bytes of the arguments: the whole model's, or one device's block
        under :attr:`slice_specs` on :attr:`mesh` (``parallel.sharding.
        shard_bytes``; the whole arguments without a mesh)."""
        from repro_torch.parallel.sharding import shard_bytes

        sizes = tree_map(
            lambda t, spec: (shard_bytes(t, spec, self.mesh)
                             if per_device and self.mesh is not None
                             else t.numel() * t.element_size()),
            self.abstract_args, self.slice_specs)
        return sum(_leaves(sizes))


@dataclasses.dataclass
class LDACell(Cell):
    """One LDA cell.

    ``fn(key, batch, stats)`` runs one FOEM step and returns ``(new_stats,
    train_ppl, sweeps)``.  ``abstract_args`` are the (2,) uint32 key, the
    (D_s, L) int32 word ids and float32 counts, and ``GlobalStats`` (φ̂
    (W, K), φ̂(k) (K,), the int32 step).  A sharded cell's φ̂ (W, K/mp) and
    φ̂(k) (K/mp,) are a rank's topic slice (``foem_sharded.shard_stats``)
    and its word ids and counts its document rows.  The stats are the
    step's donated state.
    """

    donate_argnums: Tuple[int, ...] = (2,)
    impl: str = "dense"            # "dense" | "sharded"

    def rank_args(self) -> Tuple[Any, ...]:
        """The stand-ins of the arguments one rank holds (its slice under
        :attr:`slice_specs` at its mesh coordinates; the whole arguments for
        a dense cell), on the meta device."""
        key, batch, stats = self.abstract_args
        _, batch_specs, stats_specs = self.slice_specs
        return (key, MinibatchData(*map(self._slice, batch, batch_specs)),
                GlobalStats(*map(self._slice, stats, stats_specs)))

    def _slice(self, t: torch.Tensor, spec) -> torch.Tensor:
        """``t``'s block at this rank's mesh coordinates under ``spec``
        (``parallel.sharding.block_index``: an entry may name several
        axes)."""
        if self.mesh is None:
            return t
        from repro_torch.parallel.sharding import block_index

        return t[block_index(t, spec, self.mesh)]

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
) -> LDACell:
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

    from repro_torch.parallel.sharding import lda_pspecs

    # the rules' topic-sharded layout; a dense cell's is the same with
    # nothing split (it runs on one device)
    stats_specs = lda_pspecs(mesh, shard_topics=True)
    if impl == "sharded":
        from repro_torch.core.foem_sharded import foem_step_sharded

        specs = ((None,),
                 MinibatchData(("data", None), ("data", None)),
                 stats_specs)

        def lda_step(key, batch, stats):
            # a host generator: the step folds the rank's model index into
            # one host draw from it (foem_sharded._fold_in)
            return foem_step_sharded(key_generator(key, "cpu"), batch,
                                     stats, cfg, mesh)
    else:
        from repro_torch.core.foem import foem_step

        specs = ((None,), MinibatchData((None, None), (None, None)),
                 GlobalStats(*((None,) * len(e) for e in stats_specs)))
        mesh = None

        def lda_step(key, batch, stats):
            dev = stats.phi_wk.device
            new, _, diag = foem_step(key_generator(key, dev), batch, stats,
                                     cfg, device=dev)
            return new, diag.final_train_ppl, diag.sweeps_run

    return LDACell(arch=ARCH, shape=shp, kind="lda", impl=impl, cfg=cfg,
                fn=lda_step, abstract_args=(key_abs, batch_abs, stats_abs),
                slice_specs=specs, mesh=mesh)


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------

#: The train cell's schedule (the JAX cell's): AdamW at
#: ``cosine_warmup(count, peak_lr, warmup, total)``.
LM_PEAK_LR, LM_WARMUP, LM_TOTAL_STEPS = 3e-4, 2000, 100_000


def lm_input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """The model inputs of a cell as meta-device stand-ins, with the JAX
    dtypes: int32 ``tokens`` (an audio config's ``embeds`` (B, S, d_model)
    in the model's type), int32 ``labels`` for a train cell, a VLM's
    ``image_embeds`` (B, image_tokens, d_model) in the model's type; S = 1
    for a decode cell."""
    from repro_torch.models.lm import torch_dtype

    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    dt = torch_dtype(cfg.dtype)
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio_frames":
        specs["embeds"] = _meta((B, S, cfg.d_model), dt)
    else:
        specs["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), torch.int32)
    if cfg.frontend == "image_patches":
        specs["image_embeds"] = _meta((B, cfg.image_tokens, cfg.d_model), dt)
    return specs


def input_specs(arch_name: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """The stand-in inputs of the cell (``arch_name``, ``shape_name``)."""
    from repro_torch.configs.registry import get_arch, get_shape

    cfg = get_arch(arch_name)
    return lm_input_specs(cfg, get_shape(cfg, shape_name))


def _leaves(tree) -> list:
    return tree_flatten(tree)[0]


@dataclasses.dataclass
class LMCell(Cell):
    """One LM cell.

    ``kind`` is ``"train"`` — ``fn(params, opt, batch)`` → ``(loss,
    params, opt)``, parameters and moments updated in place (the JAX cell
    donates them) —, ``"prefill"`` — ``fn(params, batch)`` → ``(logits,
    caches)`` — or ``"decode"`` — ``fn(params, caches, batch, pos)`` →
    ``(logits, caches)``, the caches written in place.  ``slice_specs``
    are the sharding rules' specs on ``mesh``.  A train cell's
    ``grad_fn(params, batch)`` → ``(loss, grads)`` is its step before the
    update: the microbatches' mean loss and gradients (float32 sums over
    ``micro_batches`` > 1, divided by it)."""

    grad_fn: Optional[Callable] = None

    def materialize(self, device: Device = "cuda", seed: int = 0,
                    opt_count: int = 0) -> Tuple[Any, ...]:
        """The whole arguments as real tensors on ``device`` (default
        ``"cuda"``): the parameters from a generator on the device seeded
        with ``seed`` (``LM.init_params``), zero moments with count
        ``opt_count`` (0: a first step, whose learning rate the warm-up
        makes 0), zero caches (``LM.init_cache``), ``pos = seq_len − 1``,
        and a batch drawn by numpy from ``seed``: tokens and labels
        uniform over the vocabulary, frame and image embeddings standard
        normal, cast to the model's type."""
        from repro_torch.models.lm import LM
        from repro_torch.optim import adamw_init

        dev = resolve_device(device)
        model = LM(self.cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init_params(gen)
        rng = np.random.default_rng(seed)
        batch = {}
        for name, t in self.abstract_args[-1 if self.kind != "decode"
                                          else 2].items():
            if t.dtype == torch.int32:
                x = rng.integers(0, self.cfg.vocab_size, t.shape,
                                 dtype=np.int32)
            else:
                x = rng.standard_normal(t.shape, dtype=np.float32)
            batch[name] = torch.from_numpy(x).to(dev, t.dtype)
        if self.kind == "train":
            opt = adamw_init(params)
            opt = opt._replace(count=torch.tensor(opt_count,
                                                  dtype=torch.int32))
            return params, opt, batch
        if self.kind == "prefill":
            return params, batch
        caches = model.init_cache(self.shape.global_batch,
                                  self.shape.seq_len)
        pos = torch.tensor(self.shape.seq_len - 1, dtype=torch.int32)
        return params, caches, batch, pos


def _model(cfg, mesh, like: torch.Tensor):
    """The LM of ``cfg`` on the device ``like`` lies on (it holds no
    weights, so building it costs nothing); a rank's mesh goes with it for
    the expert-parallel MoE."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import LM

    return LM(cfg, device=like.device,
              mesh=mesh if isinstance(mesh, Mesh) else None)


def _value_and_grad(model, params, batch):
    """The loss of ``batch`` and its gradients (the parameters' type), the
    parameters' ``requires_grad`` set for the pass and restored."""
    leaves = _leaves(params)
    flags = [p.requires_grad for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, f in zip(leaves, flags):
            p.requires_grad_(f)
    return loss.detach(), tree_unflatten(params, list(grads))


def build_lm_cell(arch, shape, mesh, *, overrides: Optional[dict] = None
                  ) -> LMCell:
    """The cell of ``arch`` (a registry name or an ``ArchConfig``, such as
    a reduced one) at ``shape`` (a name of the arch's shapes or a
    ``ShapeConfig``) on ``mesh`` (an ``AbstractMesh`` or a rank's
    ``Mesh``); ``overrides`` replaces config fields.  Allocates nothing.

    The train step is the JAX cell's: with ``micro_batches`` = mb > 1 the
    batch splits into mb microbatches along its batch axis, the gradients
    sum in float32 and are divided by mb, the loss is the microbatches'
    mean; then AdamW at ``cosine_warmup(opt.count, peak_lr=3e-4,
    warmup=2000, total=100_000)``.  The moments take the ZeRO-1 specs when
    ``cfg.zero1``, the parameters' otherwise."""
    from repro_torch.configs.base import ArchConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.models.lm import LM
    from repro_torch.optim import OptState, adamw_init, adamw_update
    from repro_torch.optim import cosine_warmup
    from repro_torch.parallel import sharding as rules

    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shp = shape if isinstance(shape, ShapeConfig) else get_shape(cfg, shape)
    abstract = LM(cfg, device="meta")
    params_abs = abstract.abstract_params()
    p_specs = rules.param_pspecs(abstract, mesh)
    batch_abs = lm_input_specs(cfg, shp)
    b_specs = rules.batch_pspecs(cfg, shp, mesh)
    b_specs = {k: b_specs[k] for k in batch_abs}   # the same keys
    common = dict(arch=cfg.name, shape=shp, kind=shp.kind, cfg=cfg,
                  mesh=mesh)

    if shp.kind == "train":
        opt_abs = adamw_init(params_abs)._replace(
            count=_meta((), torch.int32))
        m_specs = rules.zero1_pspecs(abstract, mesh) if cfg.zero1 \
            else p_specs
        o_specs = OptState(mu=m_specs, nu=m_specs, count=())
        mb = max(1, cfg.micro_batches)

        def accumulate(params, batch):
            model = _model(cfg, mesh, _leaves(params)[0])
            if mb == 1:
                return _value_and_grad(model, params, batch)
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(mb):
                micro = {k: v.reshape((mb, v.shape[0] // mb)
                                      + tuple(v.shape[1:]))[i]
                         for k, v in batch.items()}
                loss, grads = _value_and_grad(model, params, micro)
                lsum = lsum + loss
                tree_map(lambda a, g: a.add_(g.float()), gsum, grads)
                del grads
            return lsum / mb, tree_map(lambda g: g.div_(mb), gsum)

        def train_step(params, opt, batch):
            loss, grads = accumulate(params, batch)
            lr = cosine_warmup(opt.count, peak_lr=LM_PEAK_LR,
                               warmup=LM_WARMUP, total=LM_TOTAL_STEPS)
            params, opt = adamw_update(grads, opt, params, lr=lr)
            return loss, params, opt

        return LMCell(fn=train_step, grad_fn=accumulate,
                      abstract_args=(params_abs, opt_abs, batch_abs),
                      slice_specs=(p_specs, o_specs, b_specs),
                      donate_argnums=(0, 1), **common)

    if shp.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            return _model(cfg, mesh, _leaves(params)[0]).prefill(params,
                                                                 batch)

        return LMCell(fn=prefill_step, abstract_args=(params_abs, batch_abs),
                      slice_specs=(p_specs, b_specs), **common)

    cache_abs = abstract.abstract_cache(shp.global_batch, shp.seq_len)
    c_specs = rules.cache_pspecs(abstract, shp, mesh)

    @torch.no_grad()
    def decode_step(params, caches, batch, pos):
        return _model(cfg, mesh, _leaves(params)[0]).decode_step(
            params, caches, batch, pos)

    return LMCell(fn=decode_step,
                  abstract_args=(params_abs, cache_abs, batch_abs,
                                 _meta((), torch.int32)),
                  slice_specs=(p_specs, c_specs, b_specs, ()),
                  donate_argnums=(1,), **common)
