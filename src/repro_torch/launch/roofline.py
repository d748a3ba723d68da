"""Roofline terms of a step on one NVIDIA H100 (the PyTorch port of what
means something in torch of ``repro.launch.roofline``).

* The card's data-sheet peaks (H100 SXM, dense rates without sparsity, at
  the full 700 W power limit): HBM at 3.35 TB/s, float32 outside the
  tensor cores at 67 TFLOP/s, bf16 on the tensor cores at 989 TFLOP/s.
  ``chip_smoke.py`` takes its bounds from the same constants.
* :func:`lda_model_flops` and :func:`model_flops_for`: the useful FLOPs of
  an LDA step and of an LM step, the JAX package's formulas.
* :class:`Roofline`: a step's compute and memory terms against those peaks,
  the dominant one, and the step's measured time.

The JAX module's HLO walker (``parse_computations``, ``analyze_hlo``,
``roofline_from_hlo`` and its while-loop trip counts) and its ICI
collective term have no counterpart: a torch step has no HLO, and the ranks
that share one card have no link between them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: HBM bytes/s of one H100 SXM (NVIDIA data sheet).
H100_HBM_BYTES_PER_S = 3.35e12
#: float32 FLOP/s of one H100 SXM outside the tensor cores.
H100_F32_FLOPS = 67e12
#: bf16 FLOP/s of one H100 SXM on the tensor cores, dense.
H100_BF16_FLOPS = 989e12


def lda_model_flops(shape, sweeps: int = 12, active_topics: int = 16
                    ) -> float:
    """Useful FLOPs of the FOEM inner loop: the paper's 2·λkK·NNZ accounting
    (E-step multiply+normalise) + fold adds, per sweep — 8 FLOPs a token
    and active topic, for ``sweeps`` sweeps of the (D_s, L) minibatch."""
    nnz = shape.minibatch_docs * shape.bucket_len
    per_sweep = nnz * active_topics * 8.0      # eq.13 arithmetic per active topic
    return sweeps * per_sweep


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D = tokens/step
    (train), 2·N·D for a prefill, 2·N per sequence for a decode step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def lda_step_bytes(shape, sweeps: int, *, num_topics: Optional[int] = None,
                   vocab_size: Optional[int] = None) -> float:
    """The bytes an LDA step must move through HBM at least: each sweep
    reads μ and writes μ_new and the eq. 36 residual ((D_s, L, K) float32
    each), and the step reads φ̂ (W, K) and φ̂(k) once and writes them once.
    ``num_topics``/``vocab_size`` override the shape's (a rank's slice)."""
    K = shape.num_topics if num_topics is None else num_topics
    W = shape.vocab_size if vocab_size is None else vocab_size
    mu = shape.minibatch_docs * shape.bucket_len * K * 4.0
    return sweeps * 3.0 * mu + 2.0 * (W * K + K) * 4.0


@dataclasses.dataclass
class Roofline:
    """A step's roofline terms on one card: ``compute_s`` = FLOPs / peak,
    ``memory_s`` = HBM bytes / bandwidth, ``dominant`` the larger
    (``"compute"`` or ``"memory"``), and ``step_time_s`` the measured step
    (None before a run)."""

    flops: float
    hbm_bytes: float
    compute_s: float
    memory_s: float
    step_time_s: Optional[float] = None

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger term."""
        return max(self.compute_s, self.memory_s)

    @property
    def bound_fraction(self) -> Optional[float]:
        """bound_s / step_time_s: the share of the roofline reached."""
        if not self.step_time_s:
            return None
        return self.bound_s / self.step_time_s

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant,
                "bound_s": self.bound_s,
                "bound_fraction": self.bound_fraction}


def roofline(flops: float, hbm_bytes: float, *,
             step_time_s: Optional[float] = None,
             peak_flops: float = H100_F32_FLOPS,
             hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S) -> Roofline:
    """The :class:`Roofline` of ``flops`` and ``hbm_bytes`` against the
    H100's peaks (float32 by default: the LDA step computes in float32)."""
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    compute_s=flops / peak_flops,
                    memory_s=hbm_bytes / hbm_bytes_per_s,
                    step_time_s=step_time_s)
