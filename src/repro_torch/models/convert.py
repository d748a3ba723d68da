"""Weights carried across from the JAX package's ``LM`` to the port's.

The JAX ``LM.init_params`` pytree — ``embed`` (V, D) (none in an audio
config's tree), ``blocks/l{j}/…`` stacked on a leading ``nblocks`` axis
(with ``xnorm`` and ``xattn`` on a VLM's cross-attention sublayers),
``final_norm`` (D,), ``lm_head`` (D, V) — becomes the port's parameter
tree of the same names and shapes.
The port keeps the JAX matrix layout: projections are ``(in, out)`` and
applied as ``x @ W`` (``models.layers``), so no matrix is transposed.  The
tree comes as numpy arrays (``jax.device_get`` of the JAX tree); this
module imports nothing of JAX.  The MoE and Mamba2 leaves come across as
they are: the experts zero-padded to ``pad_experts(E)``, the float32
router, ``A_log``, ``D`` and ``dt_bias``.  ``cache_from_jax`` does the same
for the JAX decode caches, whose Mamba2 entries are ``SSMCache`` named
tuples and become the port's ``{"state", "conv"}`` dicts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.runtime.device import Device, resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Dict[str, Any],
                    device: Device = "cuda") -> Dict[str, Any]:
    """The port's parameter tree for the JAX ``LM.init_params`` tree
    ``tree`` (nested dicts of numpy arrays), on ``device`` (the card unless
    the caller passes ``device="cpu"``).  Shapes, types and layouts are
    kept leaf for leaf."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node).to(dev)

    return conv(tree)


def cache_from_jax(tree: Dict[str, Any],
                   device: Device = "cuda") -> Dict[str, Any]:
    """The port's caches for the JAX ``LM``'s (``init_cache`` or
    ``prefill``'s, as numpy): K/V dicts leaf for leaf, and each named tuple
    (``SSMCache``) as a dict of its fields."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {k: conv(getattr(node, k)) for k in node._fields}
        return _tensor(node).to(dev)

    return conv(tree)
