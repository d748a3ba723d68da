"""Hand-written Hopper kernels of the port and their dispatch.

* ``theta_sweep`` — frozen-φ θ-only fixed point + eq. 21 phase (serving and
                    held-out evaluation); CUDA C++ in ``csrc/theta_sweep.cu``
                    replacing ``repro.kernels.theta_sweep.theta_sweep_pallas``

Each kernel's wrapper launches it on CUDA tensors and runs its plain
PyTorch version on CPU tensors; ``build.py`` compiles the CUDA sources with
``nvcc`` at first use.  ``ops.py`` is the dispatch layer the algorithm code
calls.
"""
from repro_torch.kernels import ops, theta_sweep

__all__ = ["ops", "theta_sweep"]
