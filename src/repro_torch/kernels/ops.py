"""Kernel dispatch layer (PyTorch port of ``repro.kernels.ops``).

Two entry points, each with its eager argument contracts (``ContractError``,
the port of ``repro.analysis.validate``):

* :func:`sweep` — one column-serial Gauss-Seidel training sweep, dense
  (full-K IEM) or scheduled (active-set, §3.1), returning a ``SweepResult``.
  Every training sweep of the port (``em.gs_sweep_with_residuals``,
  ``foem`` warm-up and scheduled sweeps, the streaming trainer through
  ``foem_minibatch``) routes through it.  Each call is one
  :func:`gs_sweep.gs_sweep` or :func:`scheduled_sweep.scheduled_sweep`
  call: the Hopper kernel on the card, its plain version on the CPU.
* :func:`infer` — the frozen-φ serving fit, in chunks of one
  :func:`theta_sweep.theta_sweep` call each, with its convergence stop.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import InferPlan, InferResult, SweepPlan, SweepResult
from repro_torch.kernels.gs_sweep import gs_sweep
from repro_torch.kernels.scheduled_sweep import scheduled_sweep
from repro_torch.kernels.theta_sweep import (
    PHI_DTYPES,
    quantize_phi,
    theta_sweep,
)
from repro_torch.runtime import faults as fault_lib
from repro_torch.runtime.device import Device, resolve_device

__all__ = ["ContractError", "Device", "check_index_ranges", "infer",
           "resolve_device", "sweep", "validate_infer_args",
           "validate_sweep_args"]


class ContractError(ValueError):
    """An ``ops.sweep``/``ops.infer`` argument violates a launch contract."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ContractError(msg)


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


def _check_word_topics(word_topics, num_rows: int, num_topics: int) -> None:
    if word_topics is None:
        return
    _require(
        word_topics.ndim == 2,
        f"word_topics must be (W_s, A) per-word active topic sets, got "
        f"shape {tuple(word_topics.shape)}",
    )
    _require(
        _is_int(word_topics),
        f"word_topics must be an integer array, got dtype "
        f"{word_topics.dtype}",
    )
    _require(
        word_topics.shape[0] == num_rows,
        f"word_topics rows ({word_topics.shape[0]}) must match the phi "
        f"working-set rows W_s ({num_rows})",
    )
    _require(
        word_topics.shape[1] <= num_topics,
        f"word_topics active set A ({word_topics.shape[1]}) cannot exceed "
        f"K ({num_topics})",
    )


def validate_infer_args(
    word_ids, est_counts, theta0, phi_norm,
    *,
    ev_counts=None,
    word_topics=None,
    plan: Optional[InferPlan] = None,
    phi_dtype: str = "float32",
) -> None:
    """Check every ``ops.infer`` argument contract; raise ContractError.

    Shape/dtype-only: no tensor value is read.  ``phi_norm`` arrives as the
    caller's float32 array; quantization happens after validation.
    """
    _require(
        phi_dtype in PHI_DTYPES,
        f"phi_dtype must be one of {PHI_DTYPES}, got {phi_dtype!r}",
    )
    _require(
        plan is None or plan.axis_name is None,
        "a topic-sharded InferPlan (axis_name set) is not ported yet: "
        "sharded inference comes with the port's sharded slice",
    )
    _require(
        word_ids.ndim == 2 and _is_int(word_ids),
        f"word_ids must be a (D, L) integer array, got shape "
        f"{tuple(word_ids.shape)} dtype {word_ids.dtype}",
    )
    D, L = word_ids.shape
    _require(
        tuple(est_counts.shape) == (D, L)
        and est_counts.dtype.is_floating_point,
        f"est_counts must be a float (D, L) = ({D}, {L}) array matching "
        f"word_ids, got shape {tuple(est_counts.shape)} dtype "
        f"{est_counts.dtype}",
    )
    if ev_counts is not None:
        _require(
            tuple(ev_counts.shape) == (D, L),
            f"ev_counts must share word_ids' (D, L) = ({D}, {L}) layout "
            f"(split_heldout_counts preserves it), got "
            f"{tuple(ev_counts.shape)}",
        )
    _require(
        theta0.ndim == 2 and theta0.shape[0] == D,
        f"theta0 must be (D, K) with D = {D}, got {tuple(theta0.shape)}",
    )
    K = theta0.shape[-1]
    _require(
        phi_norm.ndim == 2 and phi_norm.shape[1] == K,
        f"phi_norm must be (W_s, K) with K = {K}, got "
        f"{tuple(phi_norm.shape)}",
    )
    _require(
        theta0.dtype == phi_norm.dtype == torch.float32,
        f"theta0 ({theta0.dtype}) and phi_norm ({phi_norm.dtype}) must both "
        "be float32: the fixed point computes in float32",
    )
    _check_word_topics(word_topics, phi_norm.shape[0], K)


def validate_sweep_args(
    word_ids, counts, mu, theta, phi_wk, phi_k,
    *,
    word_topics=None,
    token_active=None,
    plan: Optional[SweepPlan] = None,
    norm_psum=None,
    renorm_psum=None,
) -> None:
    """Check every ``ops.sweep`` argument contract; raise ContractError.

    Shape/dtype-only: no tensor value is read.
    """
    _require(
        plan is None or plan.axis_name is None,
        "a topic-sharded SweepPlan (axis_name set) is not ported yet: the "
        "sharded sweep engine comes with the port's sharded slice",
    )
    _require(
        norm_psum is None and renorm_psum is None,
        "norm_psum/renorm_psum reduction hooks are not ported yet: they "
        "come with the port's sharded slice",
    )
    _require(
        word_ids.ndim == 2 and _is_int(word_ids),
        f"word_ids must be a (D, L) integer array, got shape "
        f"{tuple(word_ids.shape)} dtype {word_ids.dtype}",
    )
    D, L = word_ids.shape
    _require(
        tuple(counts.shape) == (D, L) and counts.dtype.is_floating_point,
        f"counts must be a float (D, L) = ({D}, {L}) array matching "
        f"word_ids, got shape {tuple(counts.shape)} dtype {counts.dtype}",
    )
    _require(
        mu.ndim == 3 and tuple(mu.shape[:2]) == (D, L),
        f"mu must be (D, L, K) = ({D}, {L}, K) responsibilities, got "
        f"shape {tuple(mu.shape)}",
    )
    K = mu.shape[-1]
    _require(
        tuple(theta.shape) == (D, K),
        f"theta must be (D, K) = ({D}, {K}), got {tuple(theta.shape)}",
    )
    _require(
        phi_wk.ndim == 2 and phi_wk.shape[1] == K,
        f"phi_wk must be (W_s, K) with K = {K}, got "
        f"{tuple(phi_wk.shape)}",
    )
    _require(
        tuple(phi_k.shape) == (K,),
        f"phi_k must be (K,) = ({K},), got {tuple(phi_k.shape)}",
    )
    dtypes = {"mu": mu.dtype, "theta": theta.dtype,
              "phi_wk": phi_wk.dtype, "phi_k": phi_k.dtype}
    _require(
        set(dtypes.values()) == {torch.float32},
        "mu/theta/phi_wk/phi_k must all be float32 (the sweep computes in "
        "float32), got " + ", ".join(f"{k}={v}" for k, v in dtypes.items()),
    )
    _check_word_topics(word_topics, phi_wk.shape[0], K)
    if token_active is not None:
        _require(
            tuple(token_active.shape) == (D, L),
            f"token_active must be a (D, L) = ({D}, {L}) mask, got "
            f"{tuple(token_active.shape)}",
        )


def check_index_ranges(word_ids, word_topics, num_rows: int,
                       num_topics: int) -> None:
    """``word_ids`` must lie in [0, W_s) and ``word_topics`` in [0, K).

    The kernels read (and the sweeps write) φ rows and θ̂ lanes at these
    values without a bound check, so they are checked before a launch: one
    ``aminmax`` per array and one device sync.  Raises ContractError.
    """
    named = [("word_ids", word_ids, num_rows)]
    if word_topics is not None:
        named.append(("word_topics", word_topics, num_topics))
    named = [(n, t, hi) for n, t, hi in named if t.numel()]
    if not named:
        return
    bounds = torch.stack([torch.stack(torch.aminmax(t)).long()
                          for _, t, _ in named]).tolist()
    for (name, _, hi), (lo_v, hi_v) in zip(named, bounds):
        _require(
            0 <= lo_v and hi_v < hi,
            f"{name} values must lie in [0, {hi}), got [{lo_v}, {hi_v}]",
        )


def _tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()                # torch tensors are always writable
    return torch.as_tensor(x)


def infer(
    word_ids,                  # (D, L) int — rows into phi_norm
    est_counts,                # (D, L) estimation (80%) split counts
    theta0,                    # (D, K) float32 initial θ̂ statistics
    phi_norm,                  # (W_s, K) float32 NORMALISED φ (eq. 10), frozen
    *,
    alpha_m1: float,
    ev_counts=None,            # (D, L) evaluation (20%) split
    word_topics=None,          # (W_s, A) int: scheduled fit
    max_sweeps: int = 50,
    check_every: int = 10,
    rel_tol: float = 0.0,
    plan: Optional[InferPlan] = None,
    device: Device = "cuda",
) -> InferResult:
    """Frozen-φ inference for unseen documents — THE serving entry point.

    Paper §2.4: fit θ̂ on the estimation split by the fixed-point E-step
    with φ̂ frozen (eq. 11 without the φ M-step), then score the evaluation
    split with eq. 21.  Arguments may be numpy arrays or tensors; they move
    to ``device`` (default ``"cuda"``, which raises without a GPU).

    * The fixed point runs in ``check_every``-sweep chunks, one
      ``theta_sweep`` launch each; after each chunk the estimation-split
      perplexity ``exp(−est_loglik/ntokens)`` is compared to the previous
      chunk's (the first against +inf) and the loop stops when
      ``|last − ppl| < rel_tol·ppl``, or after ``max_sweeps`` total.
      ``rel_tol=0`` never stops early and synchronises with the device
      only once, for the index check below.  ``max_sweeps`` must be a multiple of ``check_every``.
    * ``ev_counts`` is the 20% evaluation split of the same documents; its
      eq. 21 per-token partials come out of the same launches.  ``None``
      scores nothing (serving).
    * ``word_topics`` restricts the *fit* to each word's (W_s, A) active
      topic set (``perplexity.serving_active_topics``); the eq. 21
      evaluation always uses the full support.
    * ``plan.phi_dtype`` selects the serving *storage* dtype of the frozen
      φ block: ``"bfloat16"``/``"int8"`` quantize once, before the loop
      (``theta_sweep.quantize_phi``), and every chunk reads the same stored
      values.  A sharded plan raises ``ContractError``.
    * ``word_ids`` outside [0, W_s) or ``word_topics`` outside [0, K)
      raise ``ContractError`` on every device, before any launch.
    """
    dev = resolve_device(device)
    phi_dtype = plan.phi_dtype if plan is not None else "float32"
    word_ids, est_counts = _tensor(word_ids), _tensor(est_counts)
    theta0, phi_norm = _tensor(theta0), _tensor(phi_norm)
    ev_counts = None if ev_counts is None else _tensor(ev_counts)
    word_topics = None if word_topics is None else _tensor(word_topics)
    validate_infer_args(
        word_ids, est_counts, theta0, phi_norm, ev_counts=ev_counts,
        word_topics=word_topics, plan=plan, phi_dtype=phi_dtype,
    )
    check_every = max(1, min(check_every, max_sweeps))
    if max_sweeps % check_every:
        raise ValueError(
            f"max_sweeps ({max_sweeps}) must be a multiple of "
            f"check_every ({check_every}) — the fixed point runs in "
            "check_every-sweep chunks"
        )
    n_chunks = max_sweeps // check_every

    def on_dev(t, dtype):
        return t.to(device=dev, dtype=dtype).contiguous()

    word_ids = on_dev(word_ids, torch.int32)
    est_counts = on_dev(est_counts, torch.float32)
    ev = (torch.zeros_like(est_counts) if ev_counts is None
          else on_dev(ev_counts, torch.float32))
    theta = on_dev(theta0, torch.float32)
    if word_topics is not None:
        word_topics = on_dev(word_topics, torch.int32)
    check_index_ranges(word_ids, word_topics, phi_norm.shape[0],
                       theta.shape[1])
    # Quantize the frozen φ block ONCE, outside the loop: every chunk reads
    # the same stored values.  The f32 path never touches phi_norm.
    phi_store, phi_scale = quantize_phi(on_dev(phi_norm, torch.float32),
                                        phi_dtype)

    ntok_est = est_counts.sum().clamp_min(1.0)
    last_ppl = torch.tensor(float("inf"), device=dev)
    est_ll = torch.zeros((), device=dev)
    ev_ll_tok = torch.zeros_like(est_counts)
    sweeps = 0
    for _ in range(n_chunks):
        theta, est_ll_tok, ev_ll_tok = theta_sweep(
            word_ids, est_counts, ev, theta, phi_store, word_topics,
            phi_scale, alpha_m1=alpha_m1, num_sweeps=check_every,
        )
        sweeps += check_every
        est_ll = est_ll_tok.sum()
        if rel_tol > 0:
            ppl = torch.exp(-est_ll / ntok_est)
            if bool(torch.abs(last_ppl - ppl) < rel_tol * ppl):
                break
            last_ppl = ppl
    return InferResult(
        theta=theta,
        sweeps=sweeps,
        est_loglik=est_ll,
        ev_loglik=ev_ll_tok.sum(),
        ev_loglik_doc=ev_ll_tok.sum(-1),
    )


def sweep(
    word_ids,                  # (D, L) int — rows into phi_wk
    counts,                    # (D, L) float
    mu,                        # (D, L, K) float32 responsibilities
    theta,                     # (D, K) float32
    phi_wk,                    # (W_s, K) float32 working stats
    phi_k,                     # (K,) float32
    *,
    alpha_m1: float,
    beta_m1: float,
    wb,                        # W·(β−1), with the *global* W
    word_topics=None,          # (W_s, A) int: scheduled sweep
    token_active=None,         # (D, L) bool λ_w mask (scheduled)
    compute_loglik: bool = False,
    norm_psum=None,
    renorm_psum=None,
    plan: Optional[SweepPlan] = None,
    check_indices: bool = True,
    device: Device = "cuda",
) -> SweepResult:
    """One column-serial Gauss-Seidel sweep — THE sweep entry point.

    * ``word_topics is None`` → the dense full-K IEM sweep (paper Fig. 2 at
      B = L); otherwise the §3.1 scheduled sweep on the per-word active
      sets with eq. 38 renormalisation and the ``token_active`` λ_w word
      mask (default ``counts > 0``).
    * ``compute_loglik`` also returns the post-sweep eq. 3 data
      log-likelihood (the training-perplexity stop rule), from the
      kernels' per-token partials on the card.
    * Arguments may be numpy arrays or tensors; they move to ``device``
      (default ``"cuda"``, which raises without a GPU).  On the card the
      Hopper kernels run; on the CPU their plain versions.
    * Argument contracts are checked eagerly (``ContractError``): shapes
      and dtypes, and — unless ``check_indices=False``, for a caller that
      has checked them already — ``word_ids`` in [0, W_s) and
      ``word_topics`` in [0, K), at one device sync.  A sharded ``plan``
      and the ``norm_psum``/``renorm_psum`` hooks are refused: they come
      with the sharded slice.
    * The process-wide fault plan's ``PRE_PROBE`` point fires first
      (``runtime.faults.fire_active``).
    """
    fault_lib.fire_active(fault_lib.PRE_PROBE)
    dev = resolve_device(device)
    word_ids, counts, mu = _tensor(word_ids), _tensor(counts), _tensor(mu)
    theta, phi_wk, phi_k = _tensor(theta), _tensor(phi_wk), _tensor(phi_k)
    if word_topics is not None:
        word_topics = _tensor(word_topics)
    if token_active is not None:
        token_active = _tensor(token_active)
    validate_sweep_args(
        word_ids, counts, mu, theta, phi_wk, phi_k, word_topics=word_topics,
        token_active=token_active, plan=plan, norm_psum=norm_psum,
        renorm_psum=renorm_psum,
    )

    def on_dev(t, dtype):
        return t.to(device=dev, dtype=dtype).contiguous()

    word_ids = on_dev(word_ids, torch.int32)
    counts = on_dev(counts, torch.float32)
    mu, theta = on_dev(mu, torch.float32), on_dev(theta, torch.float32)
    phi_wk = on_dev(phi_wk, torch.float32)
    phi_k = on_dev(phi_k, torch.float32)
    if word_topics is not None:
        word_topics = on_dev(word_topics, torch.int32)
        token_active = (counts > 0 if token_active is None
                        else on_dev(token_active, torch.bool))
    if check_indices:
        check_index_ranges(word_ids, word_topics, phi_wk.shape[0],
                           mu.shape[-1])
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=float(wb),
              emit_loglik=compute_loglik)
    args = (word_ids, counts, mu, theta, phi_wk, phi_k)
    if word_topics is not None:
        out = scheduled_sweep(*args, word_topics, token_active, **kw)
    else:
        out = gs_sweep(*args, **kw)
    mu_new, res, theta_o, phi_o, ptot_o, ll = out
    return SweepResult(mu_new, theta_o, phi_o, ptot_o, res, ll)
