"""Fused E-step over (tokens × topics) rows — the Hopper kernel's wrapper and
its plain PyTorch version.

One call of :func:`fused_estep` computes what one launch of the JAX
package's ``kernels/foem_estep.py::fused_estep_pallas`` computes: for every
token row, the eq. 11 responsibility normalised over K, with the optional
eq. 13 self-exclusion ``exclude`` (= counts·μ_old), and the eq. 36 residual
counts·|μ_new − μ_old|.  ``em.estep`` routes through it, and with it the
coarse-block and ``"scan"`` dense sweeps (with the exclusion), the BEM sweep
and SEM's inner loop (without).

θ̂ comes either as the TPU kernel's (T, K) rows or as (T/G, K) rows of G
consecutive tokens each (a document's θ̂ under its ``blk`` or L token
slots): no (T, K) copy of θ̂ is made on the card.  ``mu_old`` may be None:
then no residual is computed (the trainer's callers use μ alone).

* On CUDA tensors the wrapper runs the hand-written kernel
  ``csrc/fused_estep.cu`` (built with ``nvcc`` for ``sm_90a`` at first use,
  see ``kernels/build.py``): one launch, one CTA per token row, on the path
  :func:`estep_path` picks — the register path (the row's numerators held
  in registers, μ written once; 16-byte lanes where K % 4 == 0 and every
  base is 16-byte aligned, scalar lanes otherwise) for K ≤
  :data:`REG_MAX_K`, the two-pass path above it.  It never falls back.
* On CPU tensors it runs :func:`fused_estep_reference`, the plain version: a
  port of the JAX package's ``ref.fused_estep_ref`` with θ̂ expanded by
  ``repeat_interleave``.

Launch budget (``analysis.contracts``: ``fused_estep_regs``,
``fused_estep_two_pass``): a CTA of 512 (register path) or 256 threads
(two-pass) a token row, 132 bytes of static shared memory for the block
sum and no dynamic shared memory; the register path holds K ≤ 10,240 lanes.

``fused_estep.launches`` counts kernel launches (a plain integer).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import contracts, launches
from repro_torch.analysis.budget import Cell
from repro_torch.analysis.checks import kernel_fits
from repro_torch.kernels.build import count_launch
from repro_torch.kernels.gs_sweep import check_cuda_args, ptr

EstepOut = Tuple[torch.Tensor, Optional[torch.Tensor]]

#: The widest K the register path holds (``csrc/fused_estep.cu``: 512
#: threads × 5 four-lane groups), a capacity of its launch contract.
REG_MAX_K = contracts.ESTEP_REG_MAX_K


class EstepPath(NamedTuple):
    """The kernel path of one ``fused_estep`` launch: ``kind`` is
    ``"registers"`` or ``"two-pass"``; ``code`` the C entry's path number
    (0: registers with 16-byte lanes, 1: registers with scalar lanes,
    2: two-pass)."""
    kind: str
    code: int


def estep_path(K: int, operands: Sequence[Optional[torch.Tensor]]
               ) -> EstepPath:
    """The path of a ``fused_estep`` launch at width K over these operands
    (inputs and outputs; None entries are absent): the register path up to
    :data:`REG_MAX_K`, with 16-byte lanes only where K % 4 == 0 and every
    operand's base is 16-byte aligned; the two-pass path above it.  The
    register path's launch contract (``analysis.contracts``) says whether
    it fits.  A plain function of K and the addresses."""
    if not _registers_fit(K):
        return EstepPath("two-pass", 2)
    vec = K % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in operands if t is not None)
    return EstepPath("registers", 0 if vec else 1)


@functools.lru_cache(maxsize=1024)
def _registers_fit(K: int) -> bool:
    return kernel_fits("fused_estep_regs", Cell(D=1, L=1, K=K, W_s=0))


def tokens_per_row(theta_rows: int, tokens: int) -> int:
    """G, the consecutive tokens that share one θ̂ row: ``tokens //
    theta_rows``, which must divide evenly."""
    if theta_rows == tokens:
        return 1
    if theta_rows < 1 or tokens % theta_rows:
        raise ValueError(
            f"{theta_rows} theta rows do not divide {tokens} tokens")
    return tokens // theta_rows


def fused_estep_reference(
    theta_rows: torch.Tensor,          # (T, K) or (T/G, K)
    phi_rows: torch.Tensor,            # (T, K)
    phi_tot: torch.Tensor,             # (K,)
    exclude: Optional[torch.Tensor],   # (T, K) counts·μ_old, or None
    mu_old: Optional[torch.Tensor],    # (T, K), or None: no residual
    counts: Optional[torch.Tensor],    # (T,)
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,
) -> EstepOut:
    """The plain PyTorch version of :func:`fused_estep`, any device: the
    arithmetic of ``ref.fused_estep_ref`` term for term (in-place steps
    only on its own temporaries)."""
    T = phi_rows.shape[0]
    G = tokens_per_row(theta_rows.shape[0], T)
    th = theta_rows if G == 1 else theta_rows.repeat_interleave(G, 0)
    ph, pt = phi_rows, phi_tot[None, :]
    if exclude is not None:
        th = th - exclude
        ph = ph - exclude
        pt = pt - exclude
    num = th.clamp_min(0.0).add_(alpha_m1)
    del th
    num.mul_(ph.clamp_min(0.0).add_(beta_m1))
    num.div_(pt + wb)
    del ph, pt
    mu = num.div_(num.sum(-1, keepdim=True).clamp_min_(1e-30))
    if mu_old is None:
        return mu, None
    return mu, (mu - mu_old).abs_().mul_(counts[:, None])


# ---------------------------------------------------------------------------
# CUDA route
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    """The library's ctypes signatures, set once (``build.load``)."""
    fn = lib.fused_estep_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 8 + [ctypes.c_longlong, i, i, f, f, f, i, p]
    fn.restype = ctypes.c_int
    lib.fused_estep_error_string.argtypes = [ctypes.c_int]
    lib.fused_estep_error_string.restype = ctypes.c_char_p


def _launcher():
    from repro_torch.kernels import build

    return build.load("fused_estep", _bind)


def fused_estep(
    theta_rows: torch.Tensor,          # (T, K) or (T/G, K) float32
    phi_rows: torch.Tensor,            # (T, K) float32
    phi_tot: torch.Tensor,             # (K,) float32
    exclude: Optional[torch.Tensor],   # (T, K) float32, or None (BEM, SEM)
    mu_old: Optional[torch.Tensor],    # (T, K) float32, or None
    counts: Optional[torch.Tensor],    # (T,) float32 (with mu_old)
    *,
    alpha_m1: float,
    beta_m1: float,
    wb: float,                         # W·(β−1), with the *global* W
) -> EstepOut:
    """The fused E-step: ``(mu_new (T, K), residual (T, K) or None)``.

    CUDA tensors run the kernel (on the current stream, not synchronised;
    the outputs are new tensors); CPU tensors run
    :func:`fused_estep_reference`.  A row's result depends on its own
    inputs alone, bitwise, whatever T is.
    """
    wb = float(wb)
    kw = dict(alpha_m1=alpha_m1, beta_m1=beta_m1, wb=wb)
    if phi_rows.device.type == "cpu":
        return fused_estep_reference(theta_rows, phi_rows, phi_tot, exclude,
                                     mu_old, counts, **kw)
    if phi_rows.device.type != "cuda":
        raise ValueError(f"fused_estep runs on cuda or cpu, not "
                         f"{phi_rows.device}")
    T, K = phi_rows.shape
    G = tokens_per_row(theta_rows.shape[0], T)
    f32 = torch.float32
    named = [("phi_rows", phi_rows, f32, (T, K)),
             ("theta_rows", theta_rows, f32, (theta_rows.shape[0], K)),
             ("phi_tot", phi_tot, f32, (K,))]
    if exclude is not None:
        named.append(("exclude", exclude, f32, (T, K)))
    if mu_old is not None:
        named += [("mu_old", mu_old, f32, (T, K)),
                  ("counts", counts, f32, (T,))]
    check_cuda_args("fused_estep", named)
    if T >= 2 ** 31:
        raise ValueError(f"fused_estep: {T} token rows exceed the grid")
    mu = torch.empty_like(phi_rows)
    res = None if mu_old is None else torch.empty_like(phi_rows)
    if T and K:
        path = estep_path(K, (theta_rows, phi_rows, phi_tot, exclude, mu_old,
                              mu, res))
        lib = _launcher()
        with torch.cuda.device(phi_rows.device):
            rc = lib.fused_estep_launch(
                ptr(theta_rows), ptr(phi_rows), ptr(phi_tot), ptr(exclude),
                ptr(mu_old), ptr(counts if mu_old is not None else None),
                ptr(mu), ptr(res), T, K, G, float(alpha_m1), float(beta_m1),
                wb, path.code, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = lib.fused_estep_error_string(rc).decode()
            raise RuntimeError(f"fused_estep kernel launch failed: {msg} "
                               f"({rc})")
        if launches.enabled():
            kw = dict(exclude=exclude is not None, residual=mu_old is not None)
            if path.kind == "registers":
                kw["vec"] = path.code == 0
            launches.note("fused_estep", "fused_estep_regs"
                          if path.kind == "registers"
                          else "fused_estep_two_pass",
                          Cell(D=T, L=1, K=K, W_s=0), **kw)
        count_launch(fused_estep)
    return mu, res


fused_estep.launches = 0
