"""Distribution of the LM stack over a mesh (PyTorch port of
``repro.parallel``):

* ``sharding`` — the layout rules of parameters, optimizer state, batches
  and caches over a mesh's axes; they read the config levers ``fsdp``,
  ``zero1`` (the moments' specs), ``tp_size`` and ``moe_impl``, and size a
  cell per device on the production meshes (``launch.dryrun``);
* ``collectives`` — reduce-scatter + all-gather, chunked all-reduce, the
  ring all-gather, the tiled all-to-all, over a ``launch.mesh.MeshAxis``;
* ``compression`` — the int8 error-feedback all-reduce;
* ``pipeline`` — the GPipe schedule over a stage axis;
* ``moe_ep`` — the expert-parallel MoE FFN.

The LDA engine's mesh is ``launch.mesh``.  The JAX package's ``compat``
has no counterpart: it only bridges JAX API versions.
"""
from repro_torch.parallel.collectives import (
    all_gather,
    all_to_all_tokens,
    chunked_psum,
    ppermute,
    psum_scatter_then_gather,
    reduce_scatter,
    ring_all_gather,
)
from repro_torch.parallel.compression import (
    TILE,
    Carrier,
    EFState,
    compress,
    compressed_psum,
    decompress,
    ef_init,
)
from repro_torch.parallel.moe_ep import moe_apply_ep
from repro_torch.parallel.pipeline import make_pipelined_apply, pipeline_forward
from repro_torch.parallel.sharding import (
    batch_pspecs,
    cache_pspecs,
    dp_axes,
    lda_pspecs,
    param_pspecs,
    zero1_pspecs,
)

__all__ = [
    "all_gather", "all_to_all_tokens", "batch_pspecs", "cache_pspecs",
    "Carrier", "chunked_psum", "compress", "compressed_psum", "decompress",
    "dp_axes", "ef_init", "EFState", "lda_pspecs", "make_pipelined_apply",
    "moe_apply_ep", "param_pspecs", "pipeline_forward", "ppermute",
    "psum_scatter_then_gather", "reduce_scatter", "ring_all_gather", "TILE",
    "zero1_pspecs",
]
