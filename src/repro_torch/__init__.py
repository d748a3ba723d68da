"""PyTorch/CUDA port of the FOEM topic-modeling system, for NVIDIA Hopper.

A second package beside the JAX one (``repro``), mirroring its layout
(``core``, ``configs``, ``sparse``, ``data``, ``runtime``, ``kernels``,
``launch``).  It imports ``torch`` and ``numpy``, never ``jax`` and nothing
of ``repro``.  Every kernel the JAX package wrote in Pallas for the TPU
becomes a hand-written CUDA kernel under ``kernels/csrc``, with a plain
PyTorch version beside it.

This slice ports the serving path: ``launch.serve.TopicServer`` over a
disk-backed ``core.streaming.ParameterStore`` (the JAX store's on-disk
format), fitting θ through ``kernels.ops.infer`` and the frozen-φ θ-sweep
kernel.  Entry points run on the GPU by default and raise without one;
``device="cpu"`` runs the plain PyTorch path.
"""
