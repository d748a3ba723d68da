"""Sharding rules: the layout of parameters, optimizer state, batches and
decode caches over a mesh (PyTorch port of ``repro.parallel.sharding``).

Axes: ``data`` (DP; sequences, or the LDA's documents), ``model`` (TP;
heads, FFN hidden, vocabulary, experts, SSM heads, or the LDA's topics),
and, on the multi-pod mesh, ``pod`` (more DP).  A mesh is anything with
``axis_names`` and ``shape`` (name → size): the production meshes as
``launch.mesh.AbstractMesh`` descriptions, or a rank's ``launch.mesh.Mesh``.

A spec is a tuple with one entry per dimension of its tensor: ``None``
(not split), an axis name, or a tuple of axis names (the dimension split
over their product, the first the slowest) — ``tuple(P(...))`` of the JAX
package's ``PartitionSpec``, whose single-name tuples read as the name.

The rules, rule for rule the JAX package's:

* ``embed`` (V, D) → (model, None); ``lm_head`` (D, V) → (None, model);
* ``wq``/``wk``/``wv`` (D, H·hd) → (None, model), ``wo`` → (model, None);
  the kv projections are replicated when the kv heads do not divide over
  ``model`` (MQA), and the caches' sequence axis is split instead (SP);
* ``gate``/``up`` → (None, model), ``down`` → (model, None);
* the MoE experts (E, D, F) → (None, None, model) (``moe_impl="tp"``), or
  (model, None, None) (``"ep"``: the expert-parallel layout);
* Mamba2 ``in_proj`` → (None, model), ``out_proj`` → (model, None), its
  per-feature vectors on dim 0; norms replicated;
* ``model`` is dropped wherever the dimension does not divide;
* ``fsdp``: the first free dimension of every matrix that ``data``
  divides is split over ``data`` too; ``tp_size == 1``: no TP at all, and
  the first free dimension is split over (data, model);
* a leaf of the stacked super-blocks gets a leading ``None`` (block axis).

Nothing here allocates: :func:`param_pspecs` reads ``LM.abstract_params``
and :func:`cache_pspecs` ``LM.abstract_cache``, both on the meta device.
:func:`shard_shape` is a tensor's block on one device under a spec, and
:func:`block_index` a rank's block of a tensor.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

from repro_torch.checkpoint.ckpt import tree_map

Spec = Tuple[Any, ...]


def _entry(axes):
    """A spec entry: a 1-tuple of names reads as the name (as in
    ``PartitionSpec``)."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel mesh axes (``pod`` folded in when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


def _dp_size(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in dp_axes(mesh))


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested dicts, ``path`` the keys from the
    root (``jax.tree_util.tree_map_with_path`` of the port's trees)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

_BASE_RULES: Dict[str, Spec] = {
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "final_norm": (None,),
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    "gate": (None, "model"),
    "up": (None, "model"),
    "down": ("model", None),
    "router": (None, None),
    "w_gate": (None, None, "model"),
    "w_up": (None, None, "model"),
    "w_down": (None, "model", None),
    "in_proj": (None, "model"),
    "out_proj": ("model", None),
    "conv_w": ("model", None),
    "conv_b": ("model",),
    "A_log": ("model",),
    "D": ("model",),
    "dt_bias": ("model",),
    "gnorm": ("model",),
    "norm1": (None,),
    "norm2": (None,),
    "xnorm": (None,),
}


def _leaf_rule(path: Tuple[str, ...], shape_full, cfg, mesh) -> Spec:
    name = path[-1]
    in_block = "blocks" in path
    ndim = len(shape_full)
    msize = _axis_size(mesh, "model")
    no_tp = getattr(cfg, "tp_size", 0) == 1
    rule = _BASE_RULES.get(name)
    if rule is None or no_tp:
        rule = (None,) * ndim
    rule = list(rule)

    # kv projections whose HEADS cannot split over the model axis are
    # replicated (splitting the fused KV·hd dimension would cut inside a
    # head)
    if name in ("wk", "wv") and cfg.num_kv_heads % msize != 0:
        rule = [None, None]
    # EP MoE: the experts live expert-sharded over the model axis, the
    # layout the expert-parallel exchange takes them in
    if cfg.moe_impl == "ep" and name in ("w_gate", "w_up", "w_down"):
        rule = ["model", None, None]
    # dimensions that the model axis does not divide stay whole
    shape = tuple(shape_full[1:]) if in_block else tuple(shape_full)
    for i, ax in enumerate(rule):
        if ax == "model" and (i >= len(shape) or shape[i] % msize != 0):
            rule[i] = None

    # FSDP / ZeRO-3: the first free dimension over data (tp_size == 1: over
    # the combined data × model grid, the model axis being pure DP then)
    if (cfg.fsdp or no_tp) and len(shape) >= 2 and name != "router":
        axes = ("data", "model") if no_tp else ("data",)
        dsize = math.prod(_axis_size(mesh, a) for a in axes)
        for i in range(len(shape)):
            if rule[i] is None and shape[i] % dsize == 0 \
                    and shape[i] >= dsize:
                rule[i] = axes if no_tp else "data"
                break

    if in_block:
        rule = [None] + rule        # the leading super-block axis
    rule = rule[:ndim] + [None] * (ndim - len(rule))
    return tuple(_entry(r) for r in rule)


def param_pspecs(model, mesh):
    """The spec tree of ``model.abstract_params()`` (an ``LM``)."""
    return tree_map_with_path(
        lambda path, leaf: _leaf_rule(path, tuple(leaf.shape), model.cfg,
                                      mesh),
        model.abstract_params())


def zero1_pspecs(model, mesh):
    """Optimizer-state specs: the parameters' specs plus ``data`` on the
    first free dimension of every matrix that it divides (ZeRO-1: the Adam
    moments shard over data, the parameters keep their TP layout)."""
    abstract = model.abstract_params()
    base = param_pspecs(model, mesh)
    dsize = _axis_size(mesh, "data")

    def add_data(leaf, spec):
        rule = list(spec) + [None] * (leaf.ndim - len(spec))
        if leaf.ndim >= 2:
            for i in range(leaf.ndim):
                if rule[i] is None and leaf.shape[i] % dsize == 0 \
                        and leaf.shape[i] >= dsize:
                    rule[i] = "data"
                    break
        return tuple(rule)

    return tree_map(add_data, abstract, base)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_pspecs(cfg, shape, mesh) -> Dict[str, Spec]:
    """The specs of a cell's batch: ``tokens`` (or an audio config's
    ``embeds``), ``labels``, and a VLM's ``image_embeds``.  The batch
    dimension goes over the DP axes (plus ``model`` when ``tp_size == 1``)
    when they divide the global batch, else stays whole (long_500k's
    B = 1)."""
    dp = dp_axes(mesh)
    if getattr(cfg, "tp_size", 0) == 1:
        dp = dp + ("model",)        # the model axis is pure DP without TP
    dsz = math.prod(mesh.shape[a] for a in dp)
    bdim = _entry(dp) if shape.global_batch % dsz == 0 else None
    specs: Dict[str, Spec] = {}
    if cfg.frontend == "audio_frames":
        specs["embeds"] = (bdim, None, None)
    else:
        specs["tokens"] = (bdim, None)
    specs["labels"] = (bdim, None)
    if cfg.frontend == "image_patches":
        specs["image_embeds"] = (bdim, None, None)
    return specs


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def cache_pspecs(model, shape, mesh):
    """The specs of the stacked decode caches of ``model`` (an ``LM``) at
    ``shape``'s batch and length.

    K/V (nblocks, B, KV, S, hd): the batch over the DP axes when they divide
    it; the kv heads over ``model`` when it divides them, else the
    *sequence* axis (SP: the long-context / MQA fallback).  Mamba2 state
    (nblocks, B, H, P, N): heads over ``model``; conv tail (nblocks, B,
    k − 1, conv_dim): channels over ``model``, each where it divides.
    """
    cfg = model.cfg
    dp = dp_axes(mesh)
    msize = _axis_size(mesh, "model")
    bdim = (_entry(dp) if shape.global_batch % _dp_size(mesh) == 0
            else None)

    def spec_for(path, leaf):
        name = path[-1]
        if name in ("k", "v"):
            if cfg.num_kv_heads % msize == 0:
                return (None, bdim, "model", None, None)
            return (None, bdim, None, "model", None)   # sequence-parallel KV
        if name == "state":
            nh = leaf.shape[2]
            return (None, bdim, "model" if nh % msize == 0 else None, None,
                    None)
        if name == "conv":
            cd = leaf.shape[3]
            return (None, bdim, None, "model" if cd % msize == 0 else None)
        return (None,) * leaf.ndim

    return tree_map_with_path(
        spec_for, model.abstract_cache(shape.global_batch, shape.seq_len))


# ---------------------------------------------------------------------------
# the paper's LDA state
# ---------------------------------------------------------------------------

def lda_pspecs(mesh=None, *, shard_topics: bool = False):
    """Specs of ``GlobalStats``: φ̂ (W, K) over the model axis.

    ``shard_topics=False`` (default) splits the vocabulary (each device
    owns W/mp rows, the analogue of the paper's parameter streaming);
    ``shard_topics=True`` splits K (the port's sharded engine: the E-step
    needs no gather, the normaliser an all-reduce).  The rules do not
    depend on the mesh's sizes."""
    from repro_torch.core.types import GlobalStats

    if shard_topics:
        return GlobalStats(phi_wk=(None, "model"), phi_k=("model",), step=())
    return GlobalStats(phi_wk=("model", None), phi_k=(None,), step=())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _parts(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in _names(entry))


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's block of a ``shape`` tensor under
    ``spec`` (a dimension split into n parts rounds up, as XLA pads it)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // _parts(mesh, e)) for n, e in zip(shape, spec))


def shard_bytes(t, spec: Spec, mesh) -> int:
    """Bytes of one device's block of tensor ``t`` under ``spec``."""
    return math.prod(shard_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()


def block_index(t, spec: Spec, mesh):
    """The index of this rank's block of ``t`` under ``spec`` (``mesh`` a
    rank's ``launch.mesh.Mesh``; an entry of several axes counts them
    slowest first).  ``t[block_index(t, spec, mesh)]`` is the block: the
    ``shard_shape`` rows from the rank's offset, fewer in the last blocks
    of a dimension that does not divide (XLA's padding left out)."""
    index = []
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    for n, entry in zip(t.shape, spec):
        pos, parts = 0, 1
        for name in _names(entry):
            axis = getattr(mesh, name)
            pos, parts = pos * axis.size + axis.index, parts * axis.size
        rows = -(-n // parts)
        index.append(slice(min(pos * rows, n), min((pos + 1) * rows, n)))
    return tuple(index)

