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

Each kernel's wrapper launches it on CUDA tensors and runs its plain
PyTorch version on CPU tensors; ``build.py`` compiles the CUDA sources with
``nvcc`` at first use.  ``ops.py`` is the dispatch layer the algorithm code
calls.
"""
from repro_torch.kernels import gs_sweep, ops, scheduled_sweep, theta_sweep

__all__ = ["gs_sweep", "ops", "scheduled_sweep", "theta_sweep"]
