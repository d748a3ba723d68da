"""PyTorch/CUDA port of the FOEM topic-modeling system, for NVIDIA Hopper.

A second package beside the JAX one (``repro``), mirroring its layout
(``core``, ``configs``, ``sparse``, ``data``, ``runtime``, ``kernels``,
``launch``, ``models``).  It imports ``torch`` and ``numpy``, never ``jax`` and nothing
of ``repro``.  Every kernel the JAX package wrote in Pallas for the TPU
becomes a hand-written CUDA kernel under ``kernels/csrc``, with a plain
PyTorch version beside it.

Ported so far: the serving path (``launch.serve.TopicServer`` over a
disk-backed ``core.streaming.ParameterStore`` in the JAX store's on-disk
format, fitting θ through ``kernels.ops.infer`` and the frozen-φ θ-sweep
kernel) and the streaming trainer (``core.trainer.FOEMTrainer`` →
``core.foem.foem_minibatch`` → ``kernels.ops.sweep`` and the dense and
scheduled Gauss-Seidel sweep kernels), the topic-sharded step, the
coarse-block / scan trainer and SEM, and the dense decoder LM's serving
path (``models.LM`` prefill and KV-cache decode through the
flash-attention kernel).  Entry points run on the GPU by default and raise
without one; ``device="cpu"`` runs the plain PyTorch path.
"""
