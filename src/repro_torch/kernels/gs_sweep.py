"""Dense column-serial Gauss-Seidel IEM sweep — the Hopper kernel's wrapper
and its plain PyTorch version.

One call of :func:`gs_sweep` computes what one launch of the JAX package's
``kernels/gs_sweep.py::gs_sweep_pallas`` computes: one sweep over the L
token columns of a bucketed (D, L) minibatch, each column an eq. 13
self-excluded E-step normalised over K (eq. 11) whose Δ-statistics fold into
θ̂ (D, K), φ̂ (W_s, K) and φ̂(k) before the next column reads them
(Gauss-Seidel), with the eq. 36 residual counts·|Δμ| emitted per token and,
with ``emit_loglik``, the post-sweep eq. 3 data log-likelihood.

* On CUDA tensors the wrapper runs the hand-written kernel
  ``csrc/gs_sweep.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, see
  ``kernels/build.py``): one persistent cooperative launch for the L
  columns, on the path :func:`dense_path` picks, with the visiting plan of
  :func:`column_plan`, then the stop-rule launch (``csrc/sweep_common.cuh``).
  It never falls back.
* On CPU tensors it runs :func:`gs_sweep_reference`, the plain version: a
  port of the JAX package's ``ops._gs_sweep_portable`` with the E-step of
  ``ref.fused_estep_ref`` written out, and of ``ops._map_loglik`` as
  per-column :func:`loglik_partial` sums.

``gs_sweep.launches`` counts kernel calls (a plain integer), one per sweep;
``gs_sweep.launches_per_call`` is the number of CUDA operations the last
call enqueued: 2 (the barrier's zeroing, the column loop), +1 with
``emit_loglik``.  :func:`sweep_loglik_partials` runs the stop-rule phase
alone (``sweep_loglik_partials.launches`` counts it).

Launch budget (``analysis.contracts``: ``gs_loop_kernel``,
``sweep_loglik_kernel``): the column loop is one cooperative launch of
512-thread CTAs, two an SM, each with 2·4·⌈K/4⌉ floats of dynamic shared
memory (μ_old and the group sums; none on the two-pass path) and 132 bytes
static; the stop rule takes 4·⌈K/4⌉ floats of w(k) in shared memory where
they fit the 227 KB opt-in (eq. 3).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import contracts, launches
from repro_torch.analysis.budget import Cell
from repro_torch.analysis.checks import kernel_fits
from repro_torch.kernels.build import count_launch

#: The register path's widest K (512 threads × 5 float4 lane groups in
#: ``csrc/gs_sweep.cu``, a capacity of its launch contract); wider sweeps
#: take the two-pass path.
REG_MAX_K = contracts.GS_REG_GROUPS * 4
#: Documents per φ̂(k) partial sum of the column loop: a fixed group of
#: consecutive documents, so neither the grid nor padding documents at the
#: end change the sum's order.
GROUP_DOCS = 4
#: :func:`column_plan`'s token flags (kSolo, kShared in ``csrc/gs_sweep.cu``).
SOLO, SHARED = 1, 2

SweepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, Optional[torch.Tensor]]


def loglik_partial(cnt: torch.Tensor, theta: torch.Tensor,
                   ptot: torch.Tensor, rows: torch.Tensor, wb: float, *,
                   alpha_m1: float, beta_m1: float) -> torch.Tensor:
    """One column's eq. 3 data-loglik partial against the given stats:
    Σ_d x_d · log max(Σ_k θ_d(k) φ_{w_d}(k), 1e-30), with θ̂ (D, K)
    normalised by eq. 9 and the gathered (D, K) φ̂ ``rows`` by eq. 10
    (``wb`` = W·(β−1) with the global W).  The arithmetic of the JAX
    package's ``gs_sweep.loglik_partial`` and ``em.map_log_likelihood``."""
    K = theta.shape[-1]
    th_den = theta.sum(-1, keepdim=True) + K * alpha_m1
    th_n = (theta + alpha_m1) / th_den.clamp_min(1e-30)
    ph_n = (rows + beta_m1) / (ptot + wb).clamp_min(1e-30)
    lik = (th_n * ph_n).sum(-1).clamp_min(1e-30)
    return (cnt * torch.log(lik)).sum()


def sweep_loglik(word_ids: torch.Tensor, counts: torch.Tensor,
                 theta: torch.Tensor, phi_wk: torch.Tensor,
                 phi_k: torch.Tensor, wb: float, *, alpha_m1: float,
                 beta_m1: float) -> torch.Tensor:
    """The post-sweep eq. 3 data log-likelihood as the sum of the L
    per-column :func:`loglik_partial` values (the kernels' stop-rule
    phase; ``ops._map_loglik`` of the JAX package)."""
    idx = word_ids.long()
    parts = [
        loglik_partial(counts[:, l], theta, phi_k, phi_wk[idx[:, l]], wb,
                       alpha_m1=alpha_m1, beta_m1=beta_m1)
        for l in range(word_ids.shape[1])
    ]
    if not parts:
        return torch.zeros((), dtype=theta.dtype, device=theta.device)
    return torch.stack(parts).sum()


def token_loglik(word_ids: torch.Tensor, counts: torch.Tensor,
                 theta: torch.Tensor, phi_wk: torch.Tensor,
                 phi_k: torch.Tensor, wb: float, *, alpha_m1: float,
                 beta_m1: float) -> torch.Tensor:
    """The (D, L) per-token eq. 3 partials x · log max(Σ_k θ(k) φ_w(k),
    1e-30) whose column sums are :func:`loglik_partial`'s, with its
    arithmetic; zero-count tokens give 0."""
    K = theta.shape[-1]
    th_den = theta.sum(-1, keepdim=True) + K * alpha_m1
    th_n = (theta + alpha_m1) / th_den.clamp_min(1e-30)
    den = (phi_k + wb).clamp_min(1e-30)
    idx = word_ids.long()
    out = torch.zeros_like(counts)
    for l in range(word_ids.shape[1]):
        lik = (th_n * ((phi_wk[idx[:, l]] + beta_m1) / den)).sum(-1)
        out[:, l] = counts[:, l] * torch.log(lik.clamp_min(1e-30))
    return out


def gs_sweep_reference(
    word_ids: torch.Tensor,    # (D, L) int — rows into phi_wk
    counts: torch.Tensor,      # (D, L) float32
    mu: torch.Tensor,          # (D, L, K)
    theta: torch.Tensor,       # (D, K)
    phi_wk: torch.Tensor,      # (W_s, K)
    phi_k: torch.Tensor,       # (K,)
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
    emit_loglik: bool = False,
    hook: Optional[Callable[..., Tuple[torch.Tensor, ...]]] = None,
) -> SweepOut:
    """The plain PyTorch version of :func:`gs_sweep`, any device.

    A port of ``ops._gs_sweep_portable``: a Python loop over the columns,
    each gathering its D φ̂ rows, running the fused E-step and folding Δ
    into θ̂, the D rows (``index_put_`` with accumulation: duplicate words
    add in document order on the CPU) and φ̂(k).

    ``hook`` is the per-column hooks mode's reduction (``ops.sweep`` with
    ``SweepPlan(two_phase=False)`` or a raw ``norm_psum``; the JAX
    package's ``norm_psum`` argument): each column's (D, 1) E-step
    normaliser goes through ``hook(s) -> (s,)`` — a topic-sharded sweep's
    sum over the model axis — before μ divides by it.  ``None`` leaves the
    loop as it is, bit for bit.
    """
    D, L = word_ids.shape
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    phi = phi_wk.clone()
    ptot = phi_k.clone()
    idx = word_ids.long()
    for l in range(L):
        wid = idx[:, l]
        cnt = counts[:, l, None]
        mu_old = mu[:, l]
        ex = cnt * mu_old
        th = (theta - ex).clamp_min(0.0)
        ph = (phi[wid] - ex).clamp_min(0.0)
        pt = ptot[None, :] - ex
        num = (th + alpha_m1) * (ph + beta_m1) / (pt + wb)
        norm = num.sum(-1, keepdim=True)
        if hook is not None:
            (norm,) = hook(norm)
        mu_new = num / norm.clamp_min(1e-30)
        delta = cnt * mu_new - ex
        theta = theta + delta
        phi.index_put_((wid,), delta, accumulate=True)
        ptot = ptot + delta.sum(0)
        mu_out[:, l] = mu_new
        res[:, l] = cnt * (mu_new - mu_old).abs()
    if not L:
        theta = theta.clone()
    loglik = None
    if emit_loglik:
        loglik = sweep_loglik(word_ids, counts, theta, phi, ptot, wb,
                              alpha_m1=alpha_m1, beta_m1=beta_m1)
    return mu_out, res, theta, phi, ptot, loglik


def scatter_add_rows(dst: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``dst[ids[i]] += rows[i]`` in place, for the (N,) ``ids`` and the
    (N, ...) ``rows``; returns ``dst``.  Only the rows named by ``ids`` are
    touched, and duplicate ids add in a fixed order — the same bits on every
    run: on the CPU ``index_add_``, serial in index order (``index_put_``
    with accumulation adds large inputs there with parallel atomics); on
    CUDA ``index_put_`` with accumulation, which sorts the ids stably and
    sums each run of duplicates in one place (``index_add_`` uses atomics
    there)."""
    ids = ids.reshape(-1).long()
    if dst.device.type == "cpu":
        return dst.index_add_(0, ids, rows)
    return dst.index_put_((ids,), rows, accumulate=True)


def scatter_add_pairs(dst: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``dst[rows[i], cols[i]] += vals[i]`` in place on a contiguous 2-D
    ``dst``, through :func:`scatter_add_rows` on the flat int64 index: the
    same fixed order, no int32 overflow at W·K > 2³¹."""
    lin = rows.reshape(-1).long() * dst.shape[1] + cols.reshape(-1).long()
    scatter_add_rows(dst.view(-1), lin, vals.reshape(-1))
    return dst


def segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(N, K) rows summed into (num_segments, K) by the (N,) segment ids —
    ``jax.ops.segment_sum`` with a fixed accumulation order on every device
    (:func:`scatter_add_rows` into zeros; no atomics)."""
    out = torch.zeros((num_segments,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    return scatter_add_rows(out, seg, rows)


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

def column_segments(word_ids: torch.Tensor, live: torch.Tensor,
                    num_rows: int) -> Tuple[torch.Tensor, ...]:
    """The fold's per-column visiting order, on the device, without a sync.

    Each column's live tokens are sorted by word id, stably, so the
    documents of one word form a segment in document order; dead tokens
    (``live`` false) sort last and belong to no segment.  Returns four
    (L, D) int32 tensors: ``order`` (the document at each sorted position)
    and, compacted to the front of each column in position order and -1
    past the column's last segment, ``lead_pos``/``lead_end`` (a segment's
    first and one-past-last sorted position) and ``lead_word``; then the
    (L,) int32 segment count of each column.
    """
    D, L = word_ids.shape
    dev = word_ids.device
    key = torch.where(live, word_ids, num_rows).t()
    skey, order = torch.sort(key, dim=1, stable=True)
    start = torch.ones((L, D), dtype=torch.bool, device=dev)
    start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    real = skey < num_rows
    lead = start & real
    count = lead.sum(1)
    # the i-th segment of a column lands in slot i; the rest in a spare slot
    slot = torch.where(lead, torch.cumsum(lead, 1) - 1, D)
    pos = torch.arange(D, device=dev).expand(L, D)
    lead_pos = torch.full((L, D + 1), -1, dtype=torch.long,
                          device=dev).scatter_(1, slot, pos)[:, :D]
    lead_word = torch.full((L, D + 1), -1, dtype=skey.dtype,
                           device=dev).scatter_(1, slot, skey)[:, :D]
    # a segment ends where the next begins; the last where the live tokens
    # end
    lead_end = torch.full((L, D), -1, dtype=torch.long, device=dev)
    lead_end[:, :-1] = lead_pos[:, 1:]
    last = pos == (count - 1)[:, None]
    lead_end = torch.where(last, real.sum(1, keepdim=True), lead_end)

    def i32(x):
        return x.to(torch.int32).contiguous()

    return (i32(order), i32(lead_pos), i32(lead_end), i32(lead_word),
            i32(count))


def column_plan(word_ids: torch.Tensor, counts: torch.Tensor,
                num_rows: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                            ...]]:
    """The dense column loop's plan of one call, on the device, without a
    sync.

    Returns ``flags``, (D, L) uint8: :data:`SOLO` for a live token (count ≠
    0) whose word no other token of its column has, dead or live — the
    kernel folds its Δ into its φ̂ row in the E-step, since no other
    document of the column reads that row —, :data:`SHARED` for the other
    live tokens, 0 for the dead; and :func:`column_segments` over the
    SHARED tokens, the fold phase's order.
    """
    D, L = word_ids.shape
    skey, order = torch.sort(word_ids.t(), dim=1, stable=True)
    alone = torch.ones((L, D), dtype=torch.bool, device=word_ids.device)
    alone[:, 1:] &= skey[:, 1:] != skey[:, :-1]
    alone[:, :-1] &= skey[:, :-1] != skey[:, 1:]
    alone = torch.empty_like(alone).scatter_(1, order, alone).t()
    live = counts != 0
    flags = torch.where(live, torch.where(alone, SOLO, SHARED), 0)
    return (flags.to(torch.uint8).contiguous(),
            column_segments(word_ids, live & ~alone, num_rows))


def doc_groups(D: int) -> int:
    """The column loop's φ̂(k) partial sums: one per :data:`GROUP_DOCS`
    consecutive documents."""
    return -(-D // GROUP_DOCS)


class SweepPath(NamedTuple):
    kind: str   # "registers" or "two-pass"
    code: int   # the kernel's path argument: bit 0 scalar lanes, bit 1 wide


@functools.lru_cache(maxsize=1024)
def _registers_fit(K: int) -> bool:
    return kernel_fits("gs_loop_kernel", Cell(D=1, L=1, K=K, W_s=1),
                       wide=False)


def dense_path(K: int, operands: Sequence[torch.Tensor]) -> SweepPath:
    """The path of a ``gs_sweep`` launch at width K over these caller
    operands (the wrapper's own buffers are 16-byte aligned): the register
    path where its launch contract fits (K ≤ :data:`REG_MAX_K`), the
    two-pass path above it; 16-byte lanes
    only where K % 4 == 0 and every operand's base is 16-byte aligned.  A
    plain function of K and the addresses."""
    vec = K % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in operands)
    wide = not _registers_fit(K)
    return SweepPath("two-pass" if wide else "registers",
                     (0 if vec else 1) | (2 if wide else 0))


def check_cuda_args(kernel: str, named: Sequence) -> None:
    """Every operand on one CUDA device, of the given dtype and shape, and
    contiguous; raise ValueError naming the first that is not."""
    dev = named[0][1].device
    for name, t, dtype, shape in named:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{kernel}: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def dense_operands(word_ids, counts, mu, theta, phi_wk, phi_k):
    D, L = word_ids.shape
    K = mu.shape[-1]
    return [
        ("word_ids", word_ids, torch.int32, (D, L)),
        ("counts", counts, torch.float32, (D, L)),
        ("mu", mu, torch.float32, (D, L, K)),
        ("theta", theta, torch.float32, (D, K)),
        ("phi_wk", phi_wk, torch.float32, (phi_wk.shape[0], K)),
        ("phi_k", phi_k, torch.float32, (K,)),
    ]


def _bind(lib) -> None:
    """The library's ctypes signatures, set once (``build.load``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gs_sweep_launch.argtypes = (
        [p] * 18 + [i] * 5 + [f] * 4 + [ctypes.POINTER(i), p])
    lib.gs_sweep_launch.restype = ctypes.c_int
    lib.sweep_loglik_launch.argtypes = (
        [p] * 6 + [i] * 3 + [f] * 4 + [p])
    lib.sweep_loglik_launch.restype = ctypes.c_int
    lib.gs_sweep_error_string.argtypes = [ctypes.c_int]
    lib.gs_sweep_error_string.restype = ctypes.c_char_p


def _launcher():
    from repro_torch.kernels import build

    return build.load("gs_sweep", _bind)


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.gs_sweep_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def aligned16(*tensors: torch.Tensor) -> bool:
    """Every tensor's base address is 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def note_loglik(library: str, cell: Cell, theta, phi, phi_k) -> None:
    """Note the stop-rule kernel's launch (``csrc/sweep_common.cuh``: 16-byte
    lanes where K % 4 == 0 and the three bases are aligned)."""
    launches.note(library, "sweep_loglik_kernel", cell,
                  vec=cell.K % 4 == 0 and aligned16(theta, phi, phi_k))


def gs_sweep(
    word_ids: torch.Tensor,    # (D, L) int32 — rows into phi_wk
    counts: torch.Tensor,      # (D, L) float32
    mu: torch.Tensor,          # (D, L, K) float32
    theta: torch.Tensor,       # (D, K) float32
    phi_wk: torch.Tensor,      # (W_s, K) float32
    phi_k: torch.Tensor,       # (K,) float32
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                 # W·(β−1), with the *global* W
    emit_loglik: bool = False,
) -> SweepOut:
    """One dense column-serial Gauss-Seidel sweep.

    Returns ``(mu_new (D,L,K), residual (D,L,K), theta (D,K), phi_wk
    (W_s,K), phi_k (K,), loglik)`` — the six outputs of
    ``gs_sweep_pallas``; ``loglik`` is None unless ``emit_loglik``.  CUDA
    tensors run the kernel (on the current stream, not synchronised; every
    output is a new tensor); CPU tensors run :func:`gs_sweep_reference`.
    Word ids must index rows of ``phi_wk``: the kernel writes φ̂ rows at
    them without a bound check (``ops.sweep`` checks).
    """
    wb = float(wb)
    if theta.device.type == "cpu":
        return gs_sweep_reference(
            word_ids, counts, mu, theta, phi_wk, phi_k, alpha_m1=alpha_m1,
            beta_m1=beta_m1, wb=wb, emit_loglik=emit_loglik,
        )
    if theta.device.type != "cuda":
        raise ValueError(f"gs_sweep runs on cuda or cpu, not {theta.device}")
    check_cuda_args("gs_sweep", dense_operands(word_ids, counts, mu, theta,
                                               phi_wk, phi_k))
    D, L = word_ids.shape
    K = mu.shape[-1]
    mu_out = torch.empty_like(mu)
    res = torch.empty_like(mu)
    theta_o, phi_o, ptot_o = theta.clone(), phi_wk.clone(), phi_k.clone()
    tok_ll = (torch.zeros((D, L), dtype=torch.float32, device=theta.device)
              if emit_loglik else None)
    if D and L and K:
        dev = theta.device
        flags, segs = column_plan(word_ids, counts, phi_wk.shape[0])
        path = dense_path(K, [mu])
        delta = torch.empty((D, K), dtype=torch.float32, device=dev)
        part = torch.empty((doc_groups(D), K), dtype=torch.float32,
                           device=dev)
        barrier = torch.empty((1,), dtype=torch.int32, device=dev)
        enqueued = ctypes.c_int(0)
        lib = _launcher()
        with torch.cuda.device(dev):
            rc = lib.gs_sweep_launch(
                ptr(word_ids), ptr(counts), ptr(flags), ptr(mu),
                ptr(mu_out), ptr(res), ptr(theta_o), ptr(phi_o),
                ptr(ptot_o), *map(ptr, segs), ptr(delta), ptr(part),
                ptr(barrier), ptr(tok_ll), D, L, K, GROUP_DOCS, path.code,
                float(alpha_m1), float(beta_m1), wb, float(K * alpha_m1),
                ctypes.byref(enqueued),
                torch.cuda.current_stream().cuda_stream,
            )
        _raise_on(lib, rc, "gs_sweep")
        if launches.enabled():
            cell = Cell(D=D, L=L, K=K, W_s=phi_wk.shape[0])
            launches.note("gs_sweep", "gs_loop_kernel", cell,
                          vec=not path.code & 1, wide=bool(path.code & 2))
            if emit_loglik:
                note_loglik("gs_sweep", cell, theta_o, phi_o, ptot_o)
        count_launch(gs_sweep)
        gs_sweep.launches_per_call = enqueued.value
    loglik = tok_ll.sum() if emit_loglik else None
    return mu_out, res, theta_o, phi_o, ptot_o, loglik


gs_sweep.launches = 0
gs_sweep.launches_per_call = 0


def sweep_loglik_partials(
    word_ids: torch.Tensor,    # (D, L) int32 — rows into phi_wk
    counts: torch.Tensor,      # (D, L) float32
    theta: torch.Tensor,       # (D, K) float32
    phi_wk: torch.Tensor,      # (W_s, K) float32
    phi_k: torch.Tensor,       # (K,) float32
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                 # W·(β−1), with the *global* W
) -> torch.Tensor:
    """The sweeps' stop-rule phase alone: the (D, L) eq. 3 partials
    against the given statistics, whose sum is :func:`sweep_loglik`.  CUDA
    tensors run the phase's kernel (``csrc/sweep_common.cuh``, one launch,
    the one ``gs_sweep`` and ``scheduled_sweep`` run with
    ``emit_loglik``); CPU tensors run :func:`token_loglik`."""
    wb = float(wb)
    if theta.device.type == "cpu":
        return token_loglik(word_ids, counts, theta, phi_wk, phi_k, wb,
                            alpha_m1=alpha_m1, beta_m1=beta_m1)
    if theta.device.type != "cuda":
        raise ValueError(f"sweep_loglik_partials runs on cuda or cpu, not "
                         f"{theta.device}")
    D, L = word_ids.shape
    K = theta.shape[-1]
    check_cuda_args("sweep_loglik_partials", [
        ("word_ids", word_ids, torch.int32, (D, L)),
        ("counts", counts, torch.float32, (D, L)),
        ("theta", theta, torch.float32, (D, K)),
        ("phi_wk", phi_wk, torch.float32, (phi_wk.shape[0], K)),
        ("phi_k", phi_k, torch.float32, (K,)),
    ])
    out = torch.zeros((D, L), dtype=torch.float32, device=theta.device)
    if D and L and K:
        lib = _launcher()
        with torch.cuda.device(theta.device):
            rc = lib.sweep_loglik_launch(
                ptr(word_ids), ptr(counts), ptr(theta), ptr(phi_wk),
                ptr(phi_k), ptr(out), D, L, K, float(alpha_m1),
                float(beta_m1), wb, float(K * alpha_m1),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, rc, "sweep_loglik_partials")
        if launches.enabled():
            note_loglik("gs_sweep", Cell(D=D, L=L, K=K, W_s=phi_wk.shape[0]),
                        theta, phi_wk, phi_k)
        count_launch(sweep_loglik_partials)
    return out


sweep_loglik_partials.launches = 0
