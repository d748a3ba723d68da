"""Hand-written Hopper kernels of the port and their dispatch.

* ``theta_sweep``     — frozen-φ θ-only fixed point + eq. 21 phase (serving
                        and held-out evaluation); CUDA C++ in
                        ``csrc/theta_sweep.cu`` replacing
                        ``repro.kernels.theta_sweep.theta_sweep_pallas``
* ``gs_sweep``        — dense column-serial Gauss-Seidel training sweep;
                        ``csrc/gs_sweep.cu`` replacing
                        ``repro.kernels.gs_sweep.gs_sweep_pallas``
* ``scheduled_sweep`` — the active-set (§3.1) sweep;
                        ``csrc/scheduled_sweep.cu`` replacing
                        ``repro.kernels.scheduled_sweep.scheduled_sweep_pallas``
                        (both sweeps share ``csrc/sweep_common.cuh``)
* ``sharded_sweep``   — the two-phase topic-sharded probe and fold;
                        ``csrc/sharded_sweep.cu`` replacing
                        ``repro.kernels.sharded_sweep.sharded_probe_pallas``
                        and ``sharded_fold_pallas``
* ``foem_estep``      — the fused (T, K) E-step of the coarse-block and
                        ``"scan"`` sweeps, BEM and SEM;
                        ``csrc/fused_estep.cu`` replacing
                        ``repro.kernels.foem_estep.fused_estep_pallas``
* ``topk_estep``      — the (T, A) active-set E-step, and the block loop
                        that runs a whole blocked or ``"scan"`` scheduled
                        sweep in one launch; ``csrc/topk_estep.cu``
                        replacing
                        ``repro.kernels.topk_estep.topk_estep_pallas``
* ``flash_attention`` — blockwise online-softmax grouped-query attention,
                        the attention core of the LM's prefill and decode;
                        ``csrc/flash_attention.cu`` replacing
                        ``repro.kernels.flash_attention.flash_attention``

Each kernel's wrapper launches it on CUDA tensors and runs its plain
PyTorch version on CPU tensors; ``build.py`` compiles the CUDA sources with
``nvcc`` at first use.  ``ops.py`` is the dispatch layer the algorithm code
calls.
"""
from repro_torch.kernels import (
    flash_attention,
    foem_estep,
    gs_sweep,
    ops,
    scheduled_sweep,
    sharded_sweep,
    theta_sweep,
    topk_estep,
)

__all__ = ["flash_attention", "foem_estep", "gs_sweep", "ops",
           "scheduled_sweep", "sharded_sweep", "theta_sweep", "topk_estep"]
