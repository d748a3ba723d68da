"""Core typed containers for the LDA / FOEM library (PyTorch port).

Layout conventions (vocab-major, matching the paper's streaming layout), the
same as ``repro.core.types``:
  * ``phi_wk``  — (W, K) expected sufficient statistics  φ̂_w(k)  (topic-word).
  * ``phi_k``   — (K,)   topic totals                    φ̂(k) = Σ_w φ̂_w(k).
  * ``theta_dk``— (D, K) document sufficient statistics  θ̂_d(k).
  * ``mu``      — (D, L, K) responsibilities over the bucketed minibatch.

A minibatch is a *bucketed dense ragged* view of the sparse doc-word matrix:
``word_ids``/``counts`` of shape (D_s, L) where L is the bucket's max number of
distinct words per document; padding slots carry ``counts == 0``.

Random state is an explicit ``torch.Generator`` in place of a ``jax.random``
key.  The two give different numbers from one seed; the distributions are
the same.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Hyperparameters of the (smoothed, symmetric) LDA model under MAP-EM.

    The paper's EM convention: the Dirichlet pseudo-counts enter as
    ``alpha - 1`` / ``beta - 1`` (paper §4: "In the EM framework, the
    hyperparameters α − 1 = β − 1 = 0.01"). We store those offsets directly.
    Fields and defaults are those of ``repro.core.types.LDAConfig``.
    """

    num_topics: int
    vocab_size: int
    alpha_m1: float = 0.01     # α − 1
    beta_m1: float = 0.01      # β − 1
    # --- inner-loop (per-minibatch) convergence ---
    max_sweeps: int = 32       # hard cap on E/M sweeps per minibatch
    ppl_check_every: int = 10  # paper: "calculate the training perplexity every 10 iterations"
    ppl_rel_tol: float = 0.005  # relative ΔP/P stop (paper's ΔP=10 at ppl≈2k)
    # --- blocked-IEM granularity: 0 = B = L, column-serial folds ---
    iem_blocks: int = 0
    # --- column-serial sweep implementation: "fused" | "scan" ---
    sweep_impl: str = "fused"
    sweep_unroll: int = 8
    # --- dynamic scheduling (FOEM §3.1) ---
    active_topics: int = 0     # λ_k·K; 0 disables scheduling (== full IEM)
    active_words_frac: float = 1.0  # λ_w
    warmup_sweeps: int = 2     # full sweeps before scheduling kicks in
    topk_shards: int = 0       # >0: shard-local residual top-k
    dp_fold: str = "sweep"     # sharded FOEM: fold Δφ̂ per "sweep" | "minibatch"
    # --- topic-sharded sweep engine: "two_phase" | "hooks" ---
    sharded_impl: str = "two_phase"
    # --- stepwise learning-rate (SEM §2.2, eq. 18) ---
    tau0: float = 1.0
    kappa: float = 0.9
    rho_mode: str = "accumulate"  # "accumulate" (FOEM eq. 33) | "stepwise" (SEM eq. 20)
    # --- numerical-invariant checks (no port consumer yet) ---
    debug_checks: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.num_topics <= 0 or self.vocab_size <= 0:
            raise ValueError("num_topics and vocab_size must be positive")
        if self.active_topics > self.num_topics:
            raise ValueError("active_topics (λ_k·K) cannot exceed K")
        if not (0.0 < self.active_words_frac <= 1.0):
            raise ValueError("active_words_frac (λ_w) must be in (0, 1]")
        if self.rho_mode not in ("accumulate", "stepwise"):
            raise ValueError(f"unknown rho_mode {self.rho_mode!r}")
        if self.sweep_impl not in ("fused", "scan"):
            raise ValueError(f"unknown sweep_impl {self.sweep_impl!r}")
        if self.sharded_impl not in ("two_phase", "hooks"):
            raise ValueError(f"unknown sharded_impl {self.sharded_impl!r}")
        if self.sweep_unroll < 1:
            raise ValueError("sweep_unroll must be >= 1")

    @property
    def K(self) -> int:
        return self.num_topics

    @property
    def W(self) -> int:
        return self.vocab_size


class MinibatchData(NamedTuple):
    """One bucketed minibatch of the sparse doc-word stream."""

    word_ids: torch.Tensor  # (D_s, L) int32, padding == 0
    counts: torch.Tensor    # (D_s, L) float32, padding == 0.0

    @property
    def num_docs(self) -> int:
        return self.word_ids.shape[0]

    @property
    def bucket_len(self) -> int:
        return self.word_ids.shape[1]

    def ntokens(self) -> torch.Tensor:
        return self.counts.sum()


@dataclasses.dataclass(frozen=True)
class InferPlan:
    """Execution plan for ``kernels.ops.infer``.

    ``phi_dtype`` picks the *storage* dtype of the frozen, read-only φ
    block: ``"float32"`` (default), ``"bfloat16"``, or ``"int8"`` with
    symmetric per-row scales (``theta_sweep.quantize_phi``); the kernel
    dequantizes on read and computes in float32.  ``axis_name`` names the
    mesh axis of a topic-sharded plan, which this slice of the port refuses
    (``ops.infer`` raises): sharded inference comes with the sharded slice.
    """

    axis_name: Optional[str] = None
    phi_dtype: str = "float32"  # float32 | bfloat16 | int8

    def __post_init__(self):
        if self.phi_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"unknown InferPlan.phi_dtype {self.phi_dtype!r}"
            )


class InferResult(NamedTuple):
    """Everything one frozen-φ inference call produces — paper §2.4 / eq. 21.

    ``theta`` is the *sufficient-statistics* form θ̂ (normalise with
    ``em.normalize_theta`` / eq. 9 for the mixture).  ``est_loglik`` is the
    eq. 3 data log-likelihood of the estimation (80%) split under the final
    θ̂ — the convergence stop rule's measure; ``ev_loglik``/``ev_loglik_doc``
    are eq. 21's numerator Σ x^{20%} log Σ_k θ_d(k) φ_w(k) on the
    evaluation split, total and per document (zeros when no evaluation
    counts were passed).  ``sweeps`` counts the fixed-point sweeps actually
    run (a multiple of the dispatch's ``check_every``).
    """

    theta: torch.Tensor           # (D, K) final θ̂ sufficient statistics
    sweeps: int                   # fixed-point sweeps run
    est_loglik: torch.Tensor      # ()  eq. 3 data loglik, estimation split
    ev_loglik: torch.Tensor       # ()  eq. 21 numerator, evaluation split
    ev_loglik_doc: torch.Tensor   # (D,) per-document eq. 21 partials

    def perplexity(self, ev_tokens) -> torch.Tensor:
        """eq. 21: P = exp(−ev_loglik / Σ x^{20%}) for ``ev_tokens`` tokens."""
        n = torch.as_tensor(ev_tokens, dtype=self.ev_loglik.dtype,
                            device=self.ev_loglik.device)
        return torch.exp(-self.ev_loglik / n.clamp_min(1.0))


def uniform_responsibilities(generator: torch.Generator, shape,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Random-normalized init of μ (paper: 'start from random
    initializations'): U(0.5, 1.5) draws normalised over the last axis, on
    the generator's device."""
    g = torch.empty(shape, dtype=dtype, device=generator.device)
    g.uniform_(0.5, 1.5, generator=generator)
    return g / g.sum(-1, keepdim=True)
