"""Kernel dispatch layer (PyTorch port of ``repro.kernels.ops``).

Two entry points, each with its eager argument contracts (``ContractError``,
from ``analysis.validate``) and, under ``debug_checks=True``, the
numerical invariants of ``analysis.sanitizer`` on its result:

* :func:`sweep` — one column-serial Gauss-Seidel training sweep, dense
  (full-K IEM) or scheduled (active-set, §3.1), returning a ``SweepResult``.
  Every training sweep of the port (``em.gs_sweep_with_residuals``,
  ``foem`` warm-up and scheduled sweeps, the streaming trainer through
  ``foem_minibatch``) routes through it.  Each call is one
  :func:`gs_sweep.gs_sweep` or :func:`scheduled_sweep.scheduled_sweep`
  call — or, under a topic-sharded plan, the two-phase engine
  (:func:`sharded_sweep.sharded_probe`, one ``all_reduce``,
  :func:`sharded_sweep.sharded_fold`, one ``all_reduce``, the exact
  renorm): the Hopper kernels on the card, their plain versions on the CPU.
  The per-column hooks mode (``SweepPlan(two_phase=False)``, or raw
  ``norm_psum``/``renorm_psum`` hooks) runs the plain column loops on every
  device, one reduction a column: a collective cannot cross a kernel
  boundary.
* :func:`infer` — the frozen-φ serving fit, in chunks of one
  :func:`theta_sweep.theta_sweep` call each, with its convergence stop; a
  topic-sharded plan runs the fit in plain PyTorch with its reductions over
  the model axis.
* :func:`fused_estep` / :func:`topk_estep` — the (T, K) E-step of the
  coarse-block and ``"scan"`` sweeps, BEM and SEM (``em.estep``), and the
  (T, A) active-set E-step (the JAX package's ``kops.topk_estep``; the
  blocked scheduled sweep runs its arithmetic inside
  ``topk_estep.blocked_sweep``'s block loop): one
  :func:`foem_estep.fused_estep` or
  :func:`topk_estep.topk_estep` call each, on the device the tensors lie
  on.
* :func:`attention` — grouped-query attention over the flattened
  (BH, S, d) head layout, the core of the LM's ``attention_apply`` in
  prefill, decode and training: one :func:`flash_attention.flash_attention`
  call, on the device the tensors lie on; under autograd its backward is
  one :func:`flash_attention.flash_attention_backward` call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.validate import (
    PHI_DTYPES,
    ContractError,
    SanitizerError,
    refuse_debug_checks,
    require,
    validate_infer_args,
    validate_sweep_args,
)
from repro_torch.core.types import InferPlan, InferResult, SweepPlan, SweepResult
from repro_torch.kernels import foem_estep as _foem_estep
from repro_torch.kernels import topk_estep as _topk_estep
from repro_torch.kernels.gs_sweep import (
    TOTAL64,
    col_sum64,
    gs_sweep,
    gs_sweep_reference,
    segment_sum,
)
from repro_torch.kernels.scheduled_sweep import (
    scheduled_sweep,
    scheduled_sweep_reference,
)
from repro_torch.kernels.sharded_sweep import (
    loglik_partials,
    sharded_fold,
    sharded_probe,
    token_lane_masks,
)
from repro_torch.kernels.theta_sweep import quantize_phi, theta_sweep
from repro_torch.runtime import faults as fault_lib
from repro_torch.runtime.device import Device, resolve_device

__all__ = ["ContractError", "Device", "PHI_DTYPES", "SanitizerError",
           "attention", "check_index_ranges", "fused_estep", "infer",
           "refuse_debug_checks", "resolve_device", "sweep", "topk_estep",
           "validate_attention_args", "validate_estep_args",
           "validate_infer_args", "validate_sweep_args",
           "validate_topk_args"]


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
        require(
            0 <= lo_v and hi_v < hi,
            f"{name} values must lie in [0, {hi}), got [{lo_v}, {hi_v}]",
        )


def _check_same_device(named) -> None:
    devices = {t.device for _, t in named if t is not None}
    require(
        len(devices) == 1,
        "all operands must lie on one device, got "
        + ", ".join(f"{n}={t.device}" for n, t in named if t is not None),
    )


def validate_estep_args(theta_rows, phi_rows, phi_tot, exclude, mu_old,
                        counts) -> None:
    """Check every ``ops.fused_estep`` argument contract; raise
    ContractError.  Shape/dtype/device only: no tensor value is read."""
    require(
        phi_rows.ndim == 2,
        f"phi_rows must be (T, K) gathered rows, got shape "
        f"{tuple(phi_rows.shape)}",
    )
    T, K = phi_rows.shape
    require(
        theta_rows.ndim == 2 and theta_rows.shape[1] == K,
        f"theta_rows must be (T, K) or (T/G, K) with K = {K}, got "
        f"{tuple(theta_rows.shape)}",
    )
    try:
        _foem_estep.tokens_per_row(theta_rows.shape[0], T)
    except ValueError as e:
        raise ContractError(f"theta_rows: {e}") from None
    require(
        tuple(phi_tot.shape) == (K,),
        f"phi_tot must be (K,) = ({K},), got {tuple(phi_tot.shape)}",
    )
    for name, t in (("exclude", exclude), ("mu_old", mu_old)):
        require(
            t is None or tuple(t.shape) == (T, K),
            f"{name} must be (T, K) = ({T}, {K}), got "
            f"{None if t is None else tuple(t.shape)}",
        )
    require(
        mu_old is None or (counts is not None
                           and tuple(counts.shape) == (T,)),
        f"with mu_old, counts must be (T,) = ({T},), got "
        f"{None if counts is None else tuple(counts.shape)}",
    )
    named = [("theta_rows", theta_rows), ("phi_rows", phi_rows),
             ("phi_tot", phi_tot), ("exclude", exclude), ("mu_old", mu_old),
             ("counts", counts if mu_old is not None else None)]
    bad = [f"{n}={t.dtype}" for n, t in named
           if t is not None and t.dtype != torch.float32]
    require(not bad, "every fused_estep operand must be float32 (the "
                     "E-step computes in float32), got " + ", ".join(bad))
    _check_same_device(named)


def fused_estep(theta_rows, phi_rows, phi_tot, exclude, mu_old, counts, *,
                alpha_m1: float, beta_m1: float, wb):
    """The fused (T, K) E-step (eq. 11, with the eq. 13 exclusion when
    ``exclude`` is given): ``(mu_new, residual or None)``, on the device the
    tensors lie on — the kernel on the card, its plain version on the CPU.
    ``theta_rows`` is (T, K) or (T/G, K) with G consecutive tokens a row;
    ``mu_old=None`` skips the residual.
    Contracts are checked eagerly (``ContractError``)."""
    validate_estep_args(theta_rows, phi_rows, phi_tot, exclude, mu_old,
                        counts)
    return _foem_estep.fused_estep(
        theta_rows.contiguous(), phi_rows.contiguous(),
        phi_tot.contiguous(),
        None if exclude is None else exclude.contiguous(),
        None if mu_old is None else mu_old.contiguous(),
        None if mu_old is None else counts.contiguous(),
        alpha_m1=alpha_m1, beta_m1=beta_m1, wb=float(wb))


def validate_topk_args(theta_a, phi_a, ptot_a, mu_prev_a, counts,
                       active) -> None:
    """Check every ``ops.topk_estep`` argument contract; raise
    ContractError.  Shape/dtype/device only."""
    require(
        mu_prev_a.ndim == 2 and mu_prev_a.shape[1] >= 1,
        f"mu_prev_a must be (T, A) with A >= 1, got "
        f"{tuple(mu_prev_a.shape)}",
    )
    T, A = mu_prev_a.shape
    for name, t in (("theta_a", theta_a), ("phi_a", phi_a),
                    ("ptot_a", ptot_a)):
        require(
            tuple(t.shape) == (T, A),
            f"{name} must be (T, A) = ({T}, {A}), got {tuple(t.shape)}",
        )
    for name, t in (("counts", counts), ("active", active)):
        require(
            tuple(t.shape) == (T,),
            f"{name} must be (T,) = ({T},), got {tuple(t.shape)}",
        )
    named = [("theta_a", theta_a), ("phi_a", phi_a), ("ptot_a", ptot_a),
             ("mu_prev_a", mu_prev_a), ("counts", counts)]
    bad = [f"{n}={t.dtype}" for n, t in named if t.dtype != torch.float32]
    require(not bad, "theta_a/phi_a/ptot_a/mu_prev_a/counts must be "
                     "float32, got " + ", ".join(bad))
    require(active.dtype == torch.bool,
            f"active must be a bool mask, got {active.dtype}")
    _check_same_device(named + [("active", active)])


def topk_estep(theta_a, phi_a, ptot_a, mu_prev_a, counts, active, *,
               alpha_m1: float, beta_m1: float, wb):
    """The scheduled (T, A) active-set E-step (eq. 13 + eq. 38, the pad-lane
    rule and the λ_w mask): ``(mu_new_a, delta)``, on the device the tensors
    lie on — the kernel on the card, its plain version on the CPU.
    Contracts are checked eagerly (``ContractError``)."""
    validate_topk_args(theta_a, phi_a, ptot_a, mu_prev_a, counts, active)
    c = [x.contiguous() for x in (theta_a, phi_a, ptot_a, mu_prev_a,
                                  counts, active)]
    return _topk_estep.topk_estep(*c, alpha_m1=alpha_m1, beta_m1=beta_m1,
                                  wb=float(wb))


def validate_attention_args(q, k, v, *, window: int, q_offset: int) -> None:
    """Check every ``ops.attention`` argument contract — the kernel's
    (``flash_attention.check_kernel_args``: shapes, ``BH % BHkv == 0``, one
    type of float32 / bfloat16, head dim in [1, 128], one device,
    contiguity), a window >= 0 and an int32-safe q_offset — on every
    device; raise ContractError.  No tensor value is read."""
    from repro_torch.kernels import flash_attention as _flash  # LM stack

    try:
        _flash.check_kernel_args(q, k, v)
    except ValueError as e:
        raise ContractError(str(e)) from None
    require(int(window) >= 0, f"window must be >= 0 (0 = none), got {window}")
    require(abs(int(q_offset)) < 2 ** 30,
            f"q_offset must lie in (-2^30, 2^30), got {q_offset}")


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    """Grouped-query attention over the flattened (BH, Sq, d) query heads
    and (BHkv, Sk, d) KV heads (query head h reads KV head h // (BH //
    BHkv)), causal and / or within a sliding ``window``, query row i at
    position ``i + q_offset``: the kernel on the card, its plain version on
    the CPU.  The port of the JAX package's ``ops.attention``.
    Contracts are checked eagerly (``ContractError``).

    On the card, when gradients are recorded and q, k or v requires one,
    the call goes through ``flash_attention.FlashAttentionFunction``: the
    same forward, which also keeps each row's log-sum-exp, and the
    hand-written backward kernel.  On the CPU autograd differentiates the
    plain version directly."""
    validate_attention_args(q, k, v, window=window, q_offset=q_offset)
    from repro_torch.kernels import flash_attention as _flash  # LM stack

    if q.is_cuda and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _flash.FlashAttentionFunction.apply(
            q, k, v, bool(causal), int(window), int(q_offset))
    return _flash.flash_attention(q, k, v, causal=causal, window=int(window),
                                  q_offset=int(q_offset))


def _tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()                # torch tensors are always writable
    return torch.as_tensor(x)


def _infer_chunk_sharded(word_ids, est_counts, ev_counts, theta, phi_norm,
                         word_topics, *, alpha_m1, k_alpha, num_sweeps, axis):
    """``num_sweeps`` frozen-φ Jacobi sweeps + the eq. 21 phase on the
    rank's topic lanes, in plain PyTorch: the port of the JAX package's
    ``ops._infer_chunk_portable`` with ``axis_name`` set.  The θ̂ normaliser
    and the per-token μ normaliser are summed over the model ``axis`` every
    sweep (two ``all_reduce``s), the θ̂ normaliser and the pre-log eq. 21
    likelihood once more at the end of the chunk; ``k_alpha`` is the global
    K·(α−1).  Returns the rank's θ̂ slice and both splits' per-token
    log-likelihood partials (already reduced over the axis)."""
    rows = phi_norm[word_ids.long()]                          # (D, L, K)
    rows_fit = rows
    if word_topics is not None:
        rows_fit = rows * token_lane_masks(word_ids, word_topics,
                                           rows.shape[-1])

    def normalize(theta):
        (den,) = axis.all_reduce(theta.sum(-1, keepdim=True))
        return (theta + alpha_m1) / (den + k_alpha).clamp_min(1e-30)

    for _ in range(num_sweeps):
        num = normalize(theta)[:, None, :] * rows_fit         # (D, L, K)
        (denom,) = axis.all_reduce(num.sum(-1, keepdim=True))
        mu = num / denom.clamp_min(1e-30)
        theta = torch.einsum("dlk,dl->dk", mu, est_counts)
    (lik,) = axis.all_reduce(torch.einsum("dlk,dk->dl", rows,
                                          normalize(theta)))
    ll = torch.log(lik.clamp_min(1e-30))                      # full support
    return theta, est_counts * ll, ev_counts * ll


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
    debug_checks: bool = False,  # numerical-invariant sanitizer
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
      values.
    * ``plan.axis_name``, the model axis (``launch.mesh.MeshAxis``) of a
      topic-sharded mesh, fits on the rank's K/mp lanes of θ̂ and φ: every
      rank of the axis calls ``infer`` with its slices, the returned
      ``theta`` is its slice and the logliks are already reduced over the
      axis.  That fit is plain PyTorch on every device, with its
      reductions as ``all_reduce``s (:func:`_infer_chunk_sharded`): the
      θ-sweep kernel normalises each token over all K lanes inside one
      launch, and that normaliser cannot be split across ranks — as in
      the JAX package, where a sharded infer plan takes no Pallas kernel.
      It takes float32 φ only.
    * ``word_ids`` outside [0, W_s) or ``word_topics`` outside [0, K)
      raise ``ContractError`` on every device, before any launch.
    * ``debug_checks=True`` (``cfg.debug_checks``) runs the
      ``analysis.sanitizer`` invariants on the result (θ̂ finite,
      non-negative, row mass = estimation tokens; finite, non-positive
      log-likelihoods), reduced over ``plan.axis_name`` when sharded, at one
      device sync; a failure raises ``SanitizerError``.
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
    axis = plan.axis_name if plan is not None else None
    if axis is not None:
        phi_read = on_dev(phi_norm, torch.float32)
        k_alpha = theta.shape[1] * axis.size * alpha_m1     # global K·(α−1)

        def chunk(theta):
            return _infer_chunk_sharded(
                word_ids, est_counts, ev, theta, phi_read, word_topics,
                alpha_m1=alpha_m1, k_alpha=k_alpha, num_sweeps=check_every,
                axis=axis)
    else:
        # Quantize the frozen φ block ONCE, outside the loop: every chunk
        # reads the same stored values.  The f32 path never touches
        # phi_norm.
        phi_store, phi_scale = quantize_phi(on_dev(phi_norm, torch.float32),
                                            phi_dtype)

        def chunk(theta):
            return theta_sweep(
                word_ids, est_counts, ev, theta, phi_store, word_topics,
                phi_scale, alpha_m1=alpha_m1, num_sweeps=check_every,
            )

    ntok_est = est_counts.sum().clamp_min(1.0)
    last_ppl = torch.tensor(float("inf"), device=dev)
    est_ll = torch.zeros((), device=dev)
    ev_ll_tok = torch.zeros_like(est_counts)
    sweeps = 0
    for _ in range(n_chunks):
        theta, est_ll_tok, ev_ll_tok = chunk(theta)
        sweeps += check_every
        est_ll = est_ll_tok.sum()
        if rel_tol > 0:
            ppl = torch.exp(-est_ll / ntok_est)
            if bool(torch.abs(last_ppl - ppl) < rel_tol * ppl):
                break
            last_ppl = ppl
    result = InferResult(
        theta=theta,
        sweeps=sweeps,
        est_loglik=est_ll,
        ev_loglik=ev_ll_tok.sum(),
        ev_loglik_doc=ev_ll_tok.sum(-1),
    )
    if debug_checks:
        from repro_torch.analysis import sanitizer

        sanitizer.infer_invariants(result, est_counts=est_counts,
                                   axis_name=axis)
    return result


def _assemble_sharded_loglik(counts, u_glob, th_den):
    """The stop-rule value from the reduced pieces: the log AFTER the
    cross-shard sum, counts-weighted over the rank's tokens."""
    lik = (u_glob / th_den[:, None]).clamp_min(1e-30)
    return (counts * torch.log(lik)).sum()


def _sweep_two_phase(word_ids, counts, mu, theta, phi_wk, phi_k, word_topics,
                     token_active, *, alpha_m1, beta_m1, wb, axis,
                     compute_loglik, phi_k64=None) -> SweepResult:
    """The two-phase sharded sweep (the JAX package's
    ``ops._sweep_two_phase``), on the rank's K/mp topic lanes:

      A. :func:`sharded_probe` → the rank's (D, L) normaliser partials
      B. ONE ``all_reduce`` of the stacked partials over the model ``axis``
      C. :func:`sharded_fold` consuming them (own share live, peers' one
         phase stale)
      D. one more ``all_reduce`` of the live masses (+ the pre-log loglik
         partials and Σθ̂ with ``compute_loglik``) and the exact renorm
         folded into the statistics: dense Σ_k μ = 1 over all ranks,
         scheduled eq. 38's global target; the φ̂ correction is the
         deterministic :func:`segment_sum` over the rank's W rows, and
         φ̂(k) the sum of the corrected rows.

    ``phi_k64`` (``ops.sweep``'s float64 total under ``debug_checks``, seeded
    with φ̂(k)) takes phase C's fold total and then phase D's own
    correction Δ, summed in float64 — never the re-summed rows, which the
    φ̂ lockstep check compares it with.
    """
    scheduled = word_topics is not None
    D, L, K = mu.shape
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb)
    # ---- phase A: probe (Jacobi, sweep-start stats) ----
    s, pm = sharded_probe(word_ids, counts, mu, theta, phi_wk, phi_k,
                          word_topics, token_active, **kw)
    # ---- phase B: one reduction of the normaliser partials ----
    if scheduled:
        s_glob, pm_glob = axis.all_reduce(s, pm)
    else:
        (s_glob,), pm_glob = axis.all_reduce(s), None
    remainder = s_glob - s          # peers' share; own share stays live
    # ---- phase C: shard-local Gauss-Seidel fold ----
    mu_new, res, theta_o, phi_o, ptot_o, live, u = sharded_fold(
        word_ids, counts, mu, theta, phi_wk, phi_k, remainder, pm_glob,
        word_topics, token_active, **kw, emit_loglik=compute_loglik,
        phi_k64=phi_k64)
    del s, s_glob, remainder
    # ---- phase D: exact renorm + stop-rule assembly (one reduction) ----
    ll = None
    if compute_loglik:
        th_den = theta_o.sum(-1) + K * alpha_m1   # → global Σθ̂ + K(α−1)
        live_glob, u_glob, th_den = axis.all_reduce(live, u, th_den)
        ll = _assemble_sharded_loglik(counts, u_glob, th_den)
    else:
        (live_glob,) = axis.all_reduce(live)
    if scheduled:
        # rescale the active lanes' mass to eq. 38's exact global target:
        # μ + mask·μ·(scale − 1), the mask's zeros written in place
        scale = pm_glob / live_glob.clamp_min(1e-30)          # (D, L)
        corr = mu_new * (scale[..., None] - 1.0)
        corr.mul_(token_lane_masks(word_ids, word_topics, K, token_active))
        mu_corr = mu_new + corr
        del corr
    else:
        scale = 1.0 / live_glob.clamp_min(1e-30)
        mu_corr = mu_new * scale[..., None]
    # Δ = x·(μ_corr − μ) into μ's own (dead) buffer: one (D, L, K) fewer
    delta = torch.sub(mu_corr, mu_new, out=mu_new).mul_(counts[..., None])
    theta_o = theta_o + delta.sum(1)
    phi_o.add_(segment_sum(delta.reshape(D * L, K), word_ids,
                           phi_wk.shape[0]))
    if phi_k64 is not None:
        phi_k64 += col_sum64(delta.reshape(D * L, K))
    # φ̂(k) re-summed from the rows (accumulated in float64, rounded once),
    # where the JAX package adds the correction to the fold's running
    # total: a topic's per-column adds round alike in float32 against its
    # large total, so the running total drifts from the rows, sweep after
    # sweep, by more than a random walk would
    ptot_o = phi_o.sum(0, dtype=torch.float64).to(phi_o.dtype)  # lint: host-f64
    return SweepResult(mu_corr, theta_o, phi_o, ptot_o, res, ll)


def _sweep_hooks(word_ids, counts, mu, theta, phi_wk, phi_k, word_topics,
                 token_active, *, alpha_m1, beta_m1, wb, hook, axis,
                 compute_loglik, phi_k64=None) -> SweepResult:
    """The per-column hooks mode (the JAX package's ``two_phase=False``
    branch of ``ops._sweep_impl``): the plain column loop
    (:func:`gs_sweep_reference` / :func:`scheduled_sweep_reference`) with
    ``hook`` reducing each column's E-step normaliser (dense) or eq. 38
    mass and new sum (scheduled) — ``axis.all_reduce`` under a sharded
    plan, the caller's raw hook otherwise.  It runs on the device the
    tensors lie on and launches no sweep kernel.  Under a sharded plan
    φ̂(k) comes back as the float64 sum of the rank's rows, rounded once,
    as phase D of the two-phase engine leaves it (the loop's float32
    running total drifts from the rows; the JAX package keeps it), and
    ``compute_loglik`` gives the global-over-lanes eq. 3 loglik of the
    rank's documents: the pre-log partials and Σθ̂ + K(α−1) reduced in one
    more ``all_reduce``.  With a raw hook the loop's own φ̂(k) and
    shard-local loglik come back, as the hook-free loop's.  ``phi_k64``
    (``ops.sweep``'s float64 total under ``debug_checks``) takes the loop's
    own increments, not the re-summed rows."""
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb, hook=hook,
              emit_loglik=compute_loglik and axis is None, phi_k64=phi_k64)
    args = (word_ids, counts, mu, theta, phi_wk, phi_k)
    if word_topics is not None:
        out = scheduled_sweep_reference(*args, word_topics, token_active,
                                        **kw)
    else:
        out = gs_sweep_reference(*args, **kw)
    mu_new, res, theta_o, phi_o, ptot_o, ll = out
    if axis is not None:      # Σ_w φ̂_w in float64, rounded once
        ptot_o = col_sum64(phi_o).to(phi_o.dtype)
    if compute_loglik and axis is not None:
        u = loglik_partials(word_ids, theta_o, phi_o, ptot_o,
                            alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb)
        u_glob, th_den = axis.all_reduce(
            u, theta_o.sum(-1) + mu.shape[-1] * alpha_m1)
        ll = _assemble_sharded_loglik(counts, u_glob, th_den)
    return SweepResult(mu_new, theta_o, phi_o, ptot_o, res, ll)


def _one_each(fn):
    """A raw JAX-style hook (one (D, 1) array in, its sum out) as the
    column loops' hook, which takes and returns a tuple: one call a
    tensor, in order."""
    return lambda *xs: tuple(fn(x) for x in xs)


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
    debug_checks: bool = False,  # numerical-invariant sanitizer
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
      ``word_topics`` in [0, K), at one device sync.
    * ``plan.axis_name``, the model axis (``launch.mesh.MeshAxis``) of a
      topic-sharded mesh: every rank of the axis calls ``sweep`` with its
      K/mp lanes of μ, θ̂, φ̂ and φ̂(k) (and, scheduled, its shard-local
      active lanes), and the two-phase engine runs
      (:func:`_sweep_two_phase`): probe kernel, one ``all_reduce``, fold
      kernel, one ``all_reduce``, exact renorm.  ``compute_loglik`` then
      gives the global-over-lanes eq. 3 loglik of the rank's documents.
    * ``plan.two_phase=False`` with ``plan.axis_name``: the per-column
      hooks mode, the JAX package's reference semantics for the sharded
      sweep (:func:`_sweep_hooks`) — the plain column loop, on the card
      too, with one ``all_reduce`` a column (dense: the E-step normaliser;
      scheduled: the eq. 38 mass and new sum together) and, with
      ``compute_loglik``, one more for the stop rule.  No sweep kernel
      runs.
    * ``norm_psum`` (dense) / ``renorm_psum`` (scheduled), without a
      sharded plan: the same loop with the caller's raw hook, a callable
      mapping a shard-local (D, 1) column to its cross-shard sum; the
      scheduled loop calls it on the mass, then on the new sum.  A hook
      with a sharded plan, or the other form's hook, raises
      ``ContractError`` (a ``ValueError``, as the JAX refusal).
    * ``debug_checks=True`` (``cfg.debug_checks``) runs the
      ``analysis.sanitizer`` invariants on the result (μ simplex or eq. 38
      active-set mass, θ̂ row mass, φ̂ totals, signs, finiteness, inert
      padding), reduced over ``plan.axis_name`` when sharded, at one device
      sync; a failure raises ``SanitizerError``.  The kernels write every
      output into a new buffer, so the inputs are the "before" state and no
      copy of μ or φ̂ is kept.  The φ̂ totals checks read φ̂(k)'s float64
      total, which the engine that ran carries beside the float32 one
      (seeded here with the input φ̂(k), each fold site adding its own
      float32 increment; two-phase, phase D's correction summed in float64
      too): a float32 φ̂(k) at a store's magnitude rounds by more than the
      bound.  The float32 outputs are the same bits with checks and
      without.
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
    axis = plan.axis_name if plan is not None else None
    raw = norm_psum if norm_psum is not None else renorm_psum
    # φ̂(k)'s float64 total, for the φ̂ totals checks alone: the input
    # φ̂(k) (exact in float64) plus the engine's own fold increments
    total = phi_k.to(TOTAL64) if debug_checks else None
    if axis is not None and plan.two_phase:
        result = _sweep_two_phase(
            word_ids, counts, mu, theta, phi_wk, phi_k, word_topics,
            token_active, alpha_m1=alpha_m1, beta_m1=beta_m1, wb=float(wb),
            axis=axis, compute_loglik=compute_loglik, phi_k64=total)
    elif axis is not None or raw is not None:
        result = _sweep_hooks(
            word_ids, counts, mu, theta, phi_wk, phi_k, word_topics,
            token_active, alpha_m1=alpha_m1, beta_m1=beta_m1, wb=float(wb),
            hook=axis.all_reduce if axis is not None else _one_each(raw),
            axis=axis, compute_loglik=compute_loglik, phi_k64=total)
    else:
        kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=float(wb),
                  emit_loglik=compute_loglik, phi_k64=total)
        args = (word_ids, counts, mu, theta, phi_wk, phi_k)
        if word_topics is not None:
            out = scheduled_sweep(*args, word_topics, token_active, **kw)
        else:
            out = gs_sweep(*args, **kw)
        mu_new, res, theta_o, phi_o, ptot_o, ll = out
        result = SweepResult(mu_new, theta_o, phi_o, ptot_o, res, ll)
    if debug_checks:
        from repro_torch.analysis import sanitizer

        sanitizer.sweep_invariants(
            result, counts=counts, mu_before=mu, phi_wk_before=phi_wk,
            phi_k_before=phi_k, word_topics=word_topics,
            token_active=token_active, word_ids=word_ids, axis_name=axis,
            phi_k_total=total)
    return result
