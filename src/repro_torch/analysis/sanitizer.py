"""Runtime numerical-invariant sanitizer of the sweep and inference engine.

The port of ``repro.analysis.sanitizer``: opt-in checks of the EM
invariants that the paper's convergence argument rests on and that no
shape check can see —

* **μ simplex / eq. 38 mass** — a dense sweep's responsibilities sum to 1
  per counted token; a scheduled sweep keeps each token's active-set mass
  and leaves its other lanes at μ_old; under a topic-sharded plan both hold
  over all ranks (the masses are summed over the model axis first);
* **θ̂ row mass = token count** (the fold moves mass, never creates it);
* **φ̂ totals** — Δφ̂(k) moves in lockstep with the column sums of Δφ̂,
  and the total mass is conserved (summed over the model axis);
* **non-negativity** of every statistic and responsibility;
* **finiteness** of the eq. 3 and eq. 21 log-likelihoods and the eq. 36
  residuals;
* **inert padding** — zero-count and λ_w-inactive slots carry a zero
  residual.

Each message is the JAX package's, ``sanitizer: …``, letter for letter,
and ``DEFAULT_TOL`` and the scale-aware bound of ``_close`` are its own.

torch has no ``checkify``: each invariant becomes a boolean tensor on the
result's device, and :func:`sweep_invariants` / :func:`infer_invariants`
stack them all and read them in ONE host sync, then raise
:class:`~repro_torch.analysis.validate.SanitizerError` with the first
message (in the JAX package's order) that failed.  Called alone, each
``check_*`` reads its own flag and raises at once.  Under a sharded plan
the failure flags are summed over the model axis too, so every rank
raises the same first message.  A check never runs inside a CUDA graph capture
(it has to read the device).

Memory at the stream_1k width (μ is (1,024, 128, 10⁴) float32, 5.2 GB):
finiteness and signs are read from one ``amin``/``amax`` pair, never a
(D, L, K) boolean; the scheduled form gathers each token's active lanes as
(D, L, A) instead of the JAX package's dense (W_s, K) and (D, L, K)
masks, and walks μ in document chunks of at most 2²⁵ elements for the
lanes that must keep μ_old and for the padding's residual; φ̂ enters only
through its column sums, a (K,) vector.  The sweep kernels write μ into a
new buffer, so μ_old is the caller's input and costs nothing to keep.
The φ̂ column sums and totals are taken in float64 (``# lint: host-f64``):
the invariant compares differences of sums over all rows, which float32
would round by more than the tolerance at the stream_1k width.  The φ̂(k)
it checks is the float64 total that the sweep engine carries beside its
float32 one (``sweep_invariants``' ``phi_k_total``): the same float32
increments that the fold adds to φ̂(k), added in float64 from the input
φ̂(k).  A float32 φ̂(k) at a store's magnitude (≈ 5·10⁴ a topic, a
half-ulp of 2·10⁻³) cannot meet the JAX package's bound for a topic that
barely moves; the float64 total leaves the float32 rows' own rounding as
the only gap between the check's two sides.  A second check, the port's
own (:func:`check_phi_k_float32`), holds the float32 φ̂(k) that the sweep
returns, and the E-step reads, to that float64 total within float32's
own accumulated rounding.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.validate import ContractError, SanitizerError

#: Default relative tolerance for the float32 mass-conservation checks.
DEFAULT_TOL = 1e-3

#: Elements of μ a chunk of the scheduled and padding checks reads at once.
CHUNK_ELEMENTS = 1 << 25

_F64 = torch.float64  # lint: host-f64

#: float32's unit roundoff: a rounded add moves its result by at most
#: this share of the result's magnitude (a half-ulp).
U32 = 2.0 ** -24

#: The port's own check (no JAX counterpart): see check_phi_k_float32.
PHI_K_FLOAT32 = ("sanitizer: float32 phi_k parts from its float64 total by "
                 "more than float32 rounding")

Checks = Optional[List[Tuple[torch.Tensor, str]]]


def _emit(checks: Checks, ok: torch.Tensor, msg: str) -> None:
    """Queue a flag on ``checks``, or — with none — read it and raise."""
    if checks is not None:
        checks.append((ok.reshape(()), msg))
    elif not bool(ok):
        raise SanitizerError(msg)


def _psum(axis_name, *xs):
    """Sum over the model axis ``axis_name`` (a ``launch.mesh.MeshAxis``),
    in one collective."""
    if axis_name is None:
        return xs
    return axis_name.all_reduce(*xs)


def _close(a, b, tol):
    """Scale-aware |a-b| bound: tolerance grows with the masses compared."""
    return torch.all(torch.abs(a - b) <= tol * (torch.abs(a) + torch.abs(b)
                                                + 1.0))


def _doc_chunks(D: int, per_doc: int):
    step = max(1, CHUNK_ELEMENTS // max(per_doc, 1))
    for lo in range(0, D, step):
        yield slice(lo, min(D, lo + step))


def check_finite(x: torch.Tensor, what: str, checks: Checks = None) -> None:
    if x.numel() == 0:
        return
    lo, hi = torch.aminmax(x.detach().reshape(-1))
    _emit(checks, torch.isfinite(lo) & torch.isfinite(hi),
          "sanitizer: non-finite values in " + what)


def check_nonneg(x: torch.Tensor, what: str, tol: float = DEFAULT_TOL,
                 checks: Checks = None) -> None:
    if x.numel() == 0:
        return
    _emit(checks, x.detach().amin() >= -tol,
          "sanitizer: negative values in " + what)


def check_mu_simplex(mu, counts, *, axis_name=None,
                     tol: float = DEFAULT_TOL, checks: Checks = None) -> None:
    """Dense sweep: responsibilities of counted tokens sum to 1 per token
    (over all ranks of ``axis_name``: the phase-D exact-renorm claim)."""
    (mass,) = _psum(axis_name, mu.sum(-1))
    ok = torch.where(counts > 0, torch.abs(mass - 1.0),
                     torch.zeros_like(mass))
    _emit(checks, torch.all(ok <= tol),
          "sanitizer: mu rows of counted tokens do not sum to 1 "
          "(column-simplex violated)")


def _token_topics(word_ids, word_topics):
    """Each token's word's active lanes (D, L, A) and the weight of each
    (0 for a repeat of an earlier lane of the same row, so that a lane
    counts once, as in the JAX package's dense mask)."""
    wt = word_topics.long()
    srt, order = wt.sort(dim=1, stable=True)
    once = torch.ones_like(srt, dtype=torch.bool)
    once[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first = torch.empty_like(once).scatter_(1, order, once)
    idx = word_ids.long()
    return wt[idx], first[idx]


def check_active_mass(mu_new, mu_old, word_ids, word_topics, token_active,
                      *, axis_name=None, tol: float = DEFAULT_TOL,
                      checks: Checks = None) -> None:
    """Scheduled sweep: eq. 38 keeps each active token's active-set mass,
    and every other (token, topic) entry keeps μ_old."""
    top, first = _token_topics(word_ids, word_topics)
    act = (token_active if token_active is not None
           else torch.ones(word_ids.shape, dtype=torch.bool,
                           device=word_ids.device))
    w = first.to(mu_new.dtype) * act[..., None].to(mu_new.dtype)
    new, old = _psum(axis_name, (mu_new.gather(-1, top) * w).sum(-1),
                     (mu_old.gather(-1, top) * w).sum(-1))
    _emit(checks, torch.all(torch.abs(new - old) <= tol * (old + 1.0)),
          "sanitizer: eq. 38 active-set mass not preserved across the sweep")
    D, L, K = mu_new.shape
    worst = torch.zeros((), dtype=mu_new.dtype, device=mu_new.device)
    for c in _doc_chunks(D, L * K):
        diff = mu_new[c] - mu_old[c]
        keep = diff.gather(-1, top[c]) * (~act[c])[..., None]
        diff.scatter_(-1, top[c], keep)      # active lanes of active tokens
        worst = torch.maximum(worst, diff.abs_().amax())
    _emit(checks, worst <= tol,
          "sanitizer: inactive (token, topic) entries did not keep mu_old")


def check_theta_row_mass(theta, counts, *, axis_name=None,
                         tol: float = DEFAULT_TOL,
                         checks: Checks = None) -> None:
    """θ̂ row mass equals the document's token count (Σ_l counts[d, l])."""
    (row,) = _psum(axis_name, theta.sum(-1))
    _emit(checks, _close(row, counts.sum(-1), tol),
          "sanitizer: theta row mass differs from the document token count")


def check_phi_totals(phi_wk, phi_k, phi_wk_before, phi_k_before, *,
                     axis_name=None, tol: float = DEFAULT_TOL,
                     checks: Checks = None) -> None:
    """φ̂(k) moves in lockstep with φ̂'s column sums; total mass conserved.

    The delta form holds in every view the sweep engine sees (the
    streaming path sweeps a (W_s, K) row slice against the global totals);
    the total is summed over ``axis_name`` first, since mass legitimately
    moves between topic shards.  ``phi_wk_before`` may be the (W_s, K) rows or
    their (K,) column sums."""
    before = (phi_wk_before if phi_wk_before.ndim == 1
              else phi_wk_before.sum(0, dtype=_F64))
    d_col = phi_wk.sum(0, dtype=_F64) - before.to(_F64)
    d_k = phi_k.to(_F64) - phi_k_before.to(_F64)
    _emit(checks, _close(d_col, d_k, tol),
          "sanitizer: phi_k deltas inconsistent with column sums of phi_wk")
    now, was = _psum(axis_name, phi_k.sum(dtype=_F64).reshape(1),
                     phi_k_before.sum(dtype=_F64).reshape(1))
    _emit(checks, _close(now, was, tol),
          "sanitizer: total phi mass not conserved across the sweep")


def sum_order_bound(n, abs_sum):
    """How far two float32 sums of the same ≤ ``n`` terms, taken in two
    orders, can lie apart: 2·γ_n·Σ|x| (Higham's bound, γ_n = n·u / (1 −
    n·u), u = 2⁻²⁴), for ``abs_sum`` the terms' Σ|x| (a number or a
    tensor)."""
    gamma = n * U32 / (1.0 - n * U32)
    return 2.0 * gamma * abs_sum


def _weighted_col_abs(rows, weight, block: int = 1 << 14):
    """Σ_w weight_w · |rows_w| per column, in float64, a block of rows at
    a time."""
    out = torch.zeros(rows.shape[1], dtype=_F64, device=rows.device)
    for lo in range(0, rows.shape[0], block):
        blk = rows[lo:lo + block].abs().to(_F64)
        out += (blk * weight[lo:lo + block, None]).sum(0)
    return out


def check_phi_k_float32(phi_k, phi_k_total, phi_k_before, *, counts,
                        phi_wk, phi_wk_before, word_ids,
                        resummed: bool = False,
                        checks: Checks = None) -> None:
    """The float32 φ̂(k) that a sweep returns against the float64 total
    that its engine carried beside it: the two part by float32's own
    rounding and nothing else.  The port's own check: the φ̂ lockstep
    check reads the total, so this one keeps the float32 value that the
    E-step reads under watch.  ``phi_wk_before`` is the (W_s, K) rows.

    With x the batch's tokens (Σ counts, so that no topic's running value
    moves by more than 2x in a sweep, phase D's correction included):

    * a running total (one device; the hooks mode without a mesh): the L
      column adds, each rounding by at most 2⁻²⁴ of a running value ≤
      |φ̂(k)| before + after + 2x;
    * re-summed from the rows (``resummed``: a model axis, two-phase or
      hooks): the sum's own rounding; the inputs' own gap between φ̂(k)
      and the rows' column sums, which the lockstep check's deltas cancel
      and a total carries; every row add, a live token of the word each
      and one more for phase D, rounding by at most 2⁻²⁴ of the row's
      magnitude over the sweep (|before| + |after| + twice the word's
      tokens); and a column increment's other float32 summation order over
      the D documents (:func:`sum_order_bound`)."""
    f32 = phi_k.to(_F64)
    tokens = counts.sum(dtype=_F64)
    D, L = counts.shape
    if not resummed:
        bound = L * U32 * (phi_k_before.to(_F64).abs() + f32.abs()
                           + 2.0 * tokens)
    else:
        W = phi_wk.shape[0]
        live = counts > 0
        ids = word_ids[live].long()
        adds = torch.bincount(ids, minlength=W).to(_F64)
        adds += (adds > 0).to(_F64)                   # phase D's add
        own = torch.zeros(W, dtype=_F64, device=counts.device)
        own.index_add_(0, ids, counts[live].to(_F64))
        mag = (_weighted_col_abs(phi_wk_before, adds)
               + _weighted_col_abs(phi_wk, adds))
        cols = phi_wk_before.sum(0, dtype=_F64)
        bound = (U32 * (f32.abs() + mag + 2.0 * (adds * own).sum())
                 + sum_order_bound(D, 2.0 * tokens)
                 + (cols - phi_k_before.to(_F64)).abs())
    gap = (f32 - phi_k_total.to(_F64)).abs()
    _emit(checks, torch.all(gap <= bound), PHI_K_FLOAT32)


def check_padding_inert(residual, counts, token_active=None,
                        checks: Checks = None) -> None:
    """Zero-count (padding) slots — and λ_w-inactive slots — must carry
    bitwise-zero residual: mass leaking into padding is a lane-mask bug."""
    dead = counts == 0
    if token_active is not None:
        dead = dead | ~token_active
    D, L, K = residual.shape
    worst = torch.zeros((), dtype=residual.dtype, device=residual.device)
    for c in _doc_chunks(D, L * K):
        leaked = torch.where(dead[c][..., None], residual[c],
                             torch.zeros((), dtype=residual.dtype,
                                         device=residual.device))
        worst = torch.maximum(worst, leaked.abs_().amax())
    _emit(checks, worst == 0.0,
          "sanitizer: nonzero residual on zero-count/inactive padding slots")


def _raise_first(checks, axis_name) -> None:
    """Read every queued flag in one host sync and raise the first that
    failed (on every rank of ``axis_name`` alike), with every failed
    message in ``SanitizerError.failed``."""
    if not checks:
        return
    failed = (~torch.stack([ok for ok, _ in checks])).to(torch.float32)
    if axis_name is not None:
        (failed,) = axis_name.all_reduce(failed)
    msgs = [msg for bad, (_, msg) in zip(failed.tolist(), checks) if bad]
    if msgs:
        raise SanitizerError(msgs[0], msgs)


def _outside_capture(where: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise ContractError(
            f"{where}: debug_checks=True reads the device and cannot run "
            "inside a CUDA graph capture")


def sweep_invariants(result, *, counts, mu_before, phi_wk_before,
                     phi_k_before, word_topics=None, token_active=None,
                     word_ids=None, axis_name=None, phi_k_total=None,
                     tol: float = DEFAULT_TOL) -> None:
    """All post-sweep invariants of one ``ops.sweep`` result.

    ``result`` is a ``core.types.SweepResult``; ``mu_before`` /
    ``phi_wk_before`` (the rows or their column sums) / ``phi_k_before``
    the sweep's inputs.  ``word_topics`` + ``word_ids`` (+
    ``token_active``) switch the mass checks to the scheduled eq. 38 form;
    ``axis_name`` (``launch.mesh.MeshAxis``) sums the mass invariants over
    the model axis of a two-phase sharded sweep before comparing.
    ``phi_k_total``, φ̂(k)'s (K,) float64 total that the sweep engine
    carried beside the float32 one (seeded with ``phi_k_before``, its own
    fold increments added; ``ops.sweep`` under ``debug_checks``), is what
    the φ̂ totals checks read in place of ``result.phi_k``, against the
    seed ``phi_k_before``, which float64 holds exactly; without it they
    read the float32 ``result.phi_k``; with it, :func:`check_phi_k_float32`
    holds ``result.phi_k`` to the total (re-summed from the rows under
    ``axis_name``).  Raises ``SanitizerError`` with the first failed
    invariant's message."""
    _outside_capture("sweep_invariants")
    checks: List = []
    for name, val in (("mu", result.mu), ("theta", result.theta),
                      ("phi_wk", result.phi_wk), ("phi_k", result.phi_k),
                      ("residual (eq. 36)", result.residual)):
        check_finite(val, name, checks)
        check_nonneg(val, name, tol, checks)
    if result.loglik is not None:
        check_finite(result.loglik, "loglik (eq. 3)", checks)
    if word_topics is not None:
        check_active_mass(result.mu, mu_before, word_ids, word_topics,
                          token_active, axis_name=axis_name, tol=tol,
                          checks=checks)
    else:
        check_mu_simplex(result.mu, counts, axis_name=axis_name, tol=tol,
                         checks=checks)
    check_theta_row_mass(result.theta, counts, axis_name=axis_name,
                         tol=tol, checks=checks)
    check_phi_totals(result.phi_wk,
                     result.phi_k if phi_k_total is None else phi_k_total,
                     phi_wk_before, phi_k_before, axis_name=axis_name,
                     tol=tol, checks=checks)
    check_padding_inert(result.residual, counts, token_active, checks)
    if phi_k_total is not None:     # last: the JAX package's order before it
        check_phi_k_float32(result.phi_k, phi_k_total, phi_k_before,
                            counts=counts, phi_wk=result.phi_wk,
                            phi_wk_before=phi_wk_before, word_ids=word_ids,
                            resummed=axis_name is not None, checks=checks)
    _raise_first(checks, axis_name)


def infer_invariants(result, *, est_counts, axis_name=None,
                     tol: float = DEFAULT_TOL) -> None:
    """All post-inference invariants of one ``ops.infer`` result: θ̂
    finite, non-negative, with row mass equal to the estimation split's
    token count, and both splits' log-likelihoods finite and non-positive
    (a token's predictive likelihood, eq. 21, cannot exceed 1).  Raises
    ``SanitizerError`` with the first failed invariant's message."""
    _outside_capture("infer_invariants")
    checks: List = []
    check_finite(result.theta, "theta", checks)
    check_nonneg(result.theta, "theta", tol, checks)
    check_theta_row_mass(result.theta, est_counts, axis_name=axis_name,
                         tol=tol, checks=checks)
    for name, val in (("est_loglik (eq. 3)", result.est_loglik),
                      ("ev_loglik (eq. 21)", result.ev_loglik),
                      ("ev_loglik_doc", result.ev_loglik_doc)):
        check_finite(val, name, checks)
    _emit(checks, torch.as_tensor(result.est_loglik <= tol),
          "sanitizer: positive estimation-split log-likelihood")
    _emit(checks, torch.as_tensor(result.ev_loglik <= tol),
          "sanitizer: positive evaluation-split log-likelihood")
    _raise_first(checks, axis_name)
