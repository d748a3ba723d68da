"""Plain PyTorch reference of LDA under MAP-EM: one FOEM minibatch step
(the paper's Fig. 4) and the frozen-φ θ fit of serving (§2.4).

Written from the paper's equations, in PyTorch operations only; it imports
nothing of the program.  ``dtype`` is the precision it computes in:
float32 is the configuration's, bfloat16 the control's.

Notation: ``hp`` holds K, the global W, α − 1, β − 1, the active topics
A, the warm-up sweeps, the stop rule (``ppl_check_every``,
``ppl_rel_tol``) and ``max_sweeps``.  A minibatch is (D, L) local word ids
into its W_s rows and (D, L) counts, padding with count 0.

* Dense sweep (eq. 13, column-serial): the columns l = 0 … L − 1 in turn;
  within a column every document at once, each token's own contribution
  x·μ_old taken out of θ̂_d, of its word's row and of φ̂(k), the new μ
  normalised over all K topics, and x·μ_new − x·μ_old folded back before
  the next column reads them.
* Scheduled sweep (§3.1): each word's A topics of largest eq. 36 residual
  r_w(k); a token updates only those lanes, renormalised to the mass they
  held (eq. 38); r_w(k) of those lanes is replaced by the measured
  Σ x·|Δμ|, the rest kept.
* Stop rule: the training perplexity exp(−Σ x log Σ_k θ_d(k) φ_w(k) / Σ x)
  on every ``ppl_check_every``-th sweep, against the last, relative.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def exact_float32() -> None:
    """No TF32 in the reference's products: it computes in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def draw_mu0(gen: torch.Generator, shape, dtype=torch.float32
             ) -> torch.Tensor:
    """μ₀: U(0.5, 1.5) draws normalised over the last axis."""
    g = torch.empty(shape, dtype=torch.float32, device=gen.device)
    g.uniform_(0.5, 1.5, generator=gen)
    return (g / g.sum(-1, keepdim=True)).to(dtype)


def _loglik(ids, c, theta, phi, ptot, hp) -> torch.Tensor:
    """Σ x log max(Σ_k θ_d(k) φ_w(k), 1e-30), θ by eq. 9 and φ by eq. 10,
    a column at a time."""
    K, a, b = hp["K"], hp["alpha_m1"], hp["beta_m1"]
    th = (theta + a) / (theta.sum(-1, keepdim=True) + K * a).clamp_min(
        1e-30)
    den = (ptot + hp["W"] * b).clamp_min(1e-30)
    ll = torch.zeros((), dtype=torch.float64, device=theta.device)
    for l in range(ids.shape[1]):
        lik = (th * ((phi[ids[:, l]] + b) / den)).sum(-1).clamp_min(1e-30)
        ll += (c[:, l] * torch.log(lik)).sum().double()
    return ll


def _dense_sweep(ids, c, mu, theta, phi, ptot, hp, r_wk=None):
    a, b, wb = hp["alpha_m1"], hp["beta_m1"], hp["W"] * hp["beta_m1"]
    for l in range(ids.shape[1]):
        wid, cl, mo = ids[:, l], c[:, l, None], mu[:, l]
        ex = cl * mo
        th = (theta - ex).clamp_min(0.0)
        ph = (phi[wid] - ex).clamp_min(0.0)
        num = (th + a) * (ph + b) / (ptot - ex + wb)
        mn = num / num.sum(-1, keepdim=True).clamp_min(1e-30)
        delta = cl * mn - ex
        theta += delta
        phi.index_add_(0, wid, delta)
        ptot += delta.sum(0)
        if r_wk is not None:
            r_wk.index_add_(0, wid, (cl * (mn - mo)).abs())
        mu[:, l] = mn


def _scheduled_sweep(ids, c, mu, theta, phi, ptot, r_wk, hp):
    a, b, wb = hp["alpha_m1"], hp["beta_m1"], hp["W"] * hp["beta_m1"]
    topics = torch.topk(r_wk, hp["active_topics"], dim=1).indices  # (Ws, A)
    r_meas = torch.zeros_like(r_wk)
    for l in range(ids.shape[1]):
        wid, cl = ids[:, l], c[:, l, None]
        tt = topics[wid]                                          # (D, A)
        rows = wid[:, None].expand_as(tt)
        live = cl > 0
        mo = mu[:, l].gather(1, tt)
        ex = cl * mo
        th = (theta.gather(1, tt) - ex).clamp_min(0.0)
        ph = (phi[rows, tt] - ex).clamp_min(0.0)
        num = (th + a) * (ph + b) / (ptot[tt] - ex + wb)
        mn = num / num.sum(-1, keepdim=True).clamp_min(1e-30) * mo.sum(
            -1, keepdim=True)
        mn = torch.where(live, mn, mo)
        delta = cl * (mn - mo)
        theta.scatter_add_(1, tt, delta)
        phi.index_put_((rows, tt), delta, accumulate=True)
        ptot.index_add_(0, tt.reshape(-1), delta.reshape(-1))
        r_meas.index_put_((rows, tt), delta.abs(), accumulate=True)
        mu[:, l] = mu[:, l].scatter(1, tt, mn)
    # replace the active lanes' residuals, keep the others' estimates
    active = torch.zeros_like(r_wk, dtype=torch.bool).scatter_(1, topics,
                                                               True)
    return torch.where(active, r_meas, r_wk)


def foem_step(word_ids, counts, rows, phi_k, mu, hp: dict,
              sweeps: Optional[int] = None, dtype=torch.float32) -> Dict:
    """One FOEM minibatch step run for ``sweeps`` sweeps, or, when None,
    until its own stop rule or ``max_sweeps``.

    ``rows`` (W_s, K) and ``phi_k`` (K,) are the global statistics before
    the step (the minibatch not yet folded in), ``mu`` (D, L, K) the μ₀.
    Returns the rows after the step (float32), every check's
    ``(sweep, perplexity, relative change)``, the perplexity of the last
    check (the warm-up's when there is none) and the sweeps run.
    """
    ids = torch.as_tensor(word_ids).long()
    c = torch.as_tensor(counts).to(dtype)
    mu = mu.to(dtype).clone()
    D, L, K = mu.shape
    theta = torch.einsum("dlk,dl->dk", mu, c)
    phi = rows.to(dtype).clone()
    phi.index_add_(0, ids.reshape(-1), (mu * c[..., None]).reshape(-1, K))
    ptot = phi_k.to(dtype) + (mu * c[..., None]).sum((0, 1))
    ntok = c.sum().double().clamp_min(1.0)
    warm = max(1, hp["warmup_sweeps"])
    r_wk = None
    for i in range(warm):
        if i == warm - 1:
            r_wk = torch.zeros_like(phi)
        _dense_sweep(ids, c, mu, theta, phi, ptot, hp, r_wk)
    last = float(torch.exp(-_loglik(ids, c, theta, phi, ptot, hp) / ntok))
    checks: List[Tuple[int, float, float]] = []
    own = sweeps is None
    ran = warm
    for t in range(warm, hp["max_sweeps"] if own else sweeps):
        ran = t + 1
        if hp["active_topics"] > 0:
            r_wk = _scheduled_sweep(ids, c, mu, theta, phi, ptot, r_wk, hp)
        else:
            _dense_sweep(ids, c, mu, theta, phi, ptot, hp)
        if (t + 1) % hp["ppl_check_every"] == 0:
            ppl = float(torch.exp(-_loglik(ids, c, theta, phi, ptot, hp)
                                  / ntok))
            rel = abs(last - ppl) / abs(ppl)
            checks.append((t + 1, ppl, rel))
            last = ppl
            if own and rel < hp["ppl_rel_tol"]:
                break
    return {"rows": phi.float(), "phi_k": ptot, "checks": checks,
            "ppl": last, "sweeps": ran}


def stop_disagreements(checks: Sequence[Tuple[int, float, float]],
                       sweeps: int, max_sweeps: int, tol: float,
                       band: float = 0.01) -> int:
    """How many of the reference's stop decisions, taken on the sweeps the
    program ran, go against the program's: a check before the program's
    last sweep that would have stopped, or the program's last sweep (under
    ``max_sweeps``) that would not.  A relative change within ``band``·tol
    of tol decides by rounding alone and is not counted."""
    bad = 0
    for t, _, rel in checks:
        if t > sweeps:
            break
        stops = rel < tol
        want = t == sweeps and sweeps < max_sweeps
        if stops != want and abs(rel - tol) > band * tol:
            bad += 1
    return bad


def normalize_phi(rows, phi_k, hp: dict, dtype=torch.float32):
    """eq. 10 over the global W: (φ̂_w(k) + β − 1) / (φ̂(k) + W(β − 1))."""
    b = hp["beta_m1"]
    return ((rows.to(dtype) + b)
            / (phi_k.to(dtype) + hp["W"] * b).clamp_min(1e-30))


def theta0(seeds: Sequence[int], counts: torch.Tensor, K: int,
           dtype=torch.float32) -> torch.Tensor:
    """(B, K) θ̂₀: row i folds its counts through μ₀ of shape (L, K) drawn
    from a generator seeded with ``seeds[i]`` alone."""
    B, L = counts.shape
    out = torch.zeros((B, K), dtype=dtype, device=counts.device)
    gen = torch.Generator(device=counts.device)
    for i, s in enumerate(seeds):
        gen.manual_seed(int(s))
        out[i] = (draw_mu0(gen, (L, K), dtype)
                  * counts[i, :, None].to(dtype)).sum(0)
    return out


def theta_fit(word_ids, counts, theta, phin, hp: dict, sweeps: int,
              dtype=torch.float32) -> Dict:
    """The frozen-φ θ fit for ``sweeps`` sweeps (Jacobi: μ from θ̂ and the
    normalised φ rows, then θ̂ = Σ x μ), with the stop rule's perplexity
    after every ``ppl_check_every`` sweeps, compared with the last (the
    first with +inf).  Returns θ by eq. 9 (float32) and the checks."""
    K, a = hp["K"], hp["alpha_m1"]
    ids = torch.as_tensor(word_ids).long()
    c = torch.as_tensor(counts).to(dtype)
    rows = phin.to(dtype)[ids]                                  # (B, L, K)
    theta = theta.to(dtype)
    ntok = c.sum().double().clamp_min(1.0)

    def norm(th):
        return (th + a) / (th.sum(-1, keepdim=True) + K * a).clamp_min(1e-30)

    checks, last = [], float("inf")
    every = hp["ppl_check_every"]
    for t in range(sweeps):
        num = norm(theta)[:, None, :] * rows
        mu = num / num.sum(-1, keepdim=True).clamp_min(1e-30)
        theta = torch.einsum("dlk,dl->dk", mu, c)
        del num, mu
        if (t + 1) % every == 0:
            lik = torch.einsum("dlk,dk->dl", rows, norm(theta))
            ll = (c * torch.log(lik.clamp_min(1e-30))).sum().double()
            ppl = float(torch.exp(-ll / ntok))
            checks.append((t + 1, ppl, abs(last - ppl) / abs(ppl)))
            last = ppl
    return {"theta": norm(theta).float(), "checks": checks}


def gap_l1(got: torch.Tensor, want: torch.Tensor) -> float:
    """Σ|got − want| / Σ|want|, summed in float64."""
    num = (got - want).abs().sum(dtype=torch.float64)
    return float(num / want.abs().sum(dtype=torch.float64).clamp_min(1e-300))


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
