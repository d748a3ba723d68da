"""Frozen-φ inference (θ-only fixed point, paper §2.4) — the Hopper kernel's
wrapper, its plain PyTorch version, and the serving φ quantization.

One call of :func:`theta_sweep` computes what one launch of the JAX
package's ``kernels/theta_sweep.py::theta_sweep_pallas`` computes:
``num_sweeps`` Jacobi sweeps of the fixed point

    μ_{w,d}(k) ∝ θ_d(k) · φ_w(k)          (eq. 11, φ̂ frozen)
    θ̂_d(k)    = Σ_w x^{80%}_{w,d} μ_{w,d}(k)

followed by the eq. 21 phase, which emits per-token ``x·log Σ_k θ_d(k)
φ_w(k)`` for both count splits against the final θ̂.  ``word_topics``
restricts each token's *fit* to its word's A active topics (the scheduled
variant); the evaluation always uses the full support.  φ arrives
normalised (eq. 10) and read-only as float32, bfloat16, or int8 with a
per-row float32 scale (:func:`quantize_phi`), and is dequantized on read.

* On CUDA tensors the wrapper launches the hand-written kernel
  ``csrc/theta_sweep.cu`` (built with ``nvcc`` for ``sm_90a`` at first use,
  see ``kernels/build.py``) or raises.  It never falls back.  One CTA runs
  one document; :func:`doc_order` puts the longest first, and
  :func:`sweep_path` picks the kernel path: the register paths (K ≤
  :data:`REG_MAX_K`: θ̂ state in registers, φ rows through a shared-memory
  ring filled by TMA; 16-byte row reads where rows are 16-byte aligned),
  else the wide path with the state in shared memory or, when 3·K floats
  do not fit, in a global scratch.
* On CPU tensors it runs :func:`theta_sweep_reference`, the plain version:
  a port of the JAX package's ``ops._infer_chunk_portable`` that gathers the
  (D, L, K) rows once and runs the sweeps as ``einsum``s.  The tests hold the
  port against the JAX package with it; on the card ``chip_smoke.py`` holds
  the kernel against it.

``theta_sweep.launches`` counts kernel launches (a plain integer).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

#: Serving φ storage dtypes ``ops.infer`` accepts (InferPlan.phi_dtype).
PHI_DTYPES = ("float32", "bfloat16", "int8")

_PHI_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: Dynamic shared memory one CTA may take on Hopper (227 KB opt-in less the
#: kernel's 132 bytes of static reduction space, with margin).  The kernel
#: keeps 3·K floats per document there when they fit, else in a global
#: scratch the wrapper allocates.
SMEM_BUDGET = 232_448 - 1024

#: The register paths (``csrc/theta_sweep.cu``): 512 threads a document,
#: 5 four-lane groups a thread, so K ≤ 10,240; two CTAs an SM, each with at
#: most RING_BUDGET bytes of dynamic shared memory for the φ-row ring (and,
#: scheduled, θ̂'s 8·K bytes of state and two 8 KB staging buffers) and the
#: document's 16·L bytes of staged token columns.
REG_MAX_K = 512 * 4 * 5
RING_BUDGET = 108 * 1024
MAX_SLOTS = 8
SCHED_STAGE = 1024                     # (token, lane) entries a buffer
#: Rows that share one block reduction, by φ element size (f32, bf16, int8).
GROUP_ROWS = {4: 1, 2: 2, 1: 4}


class SweepPath(NamedTuple):
    """The kernel path of a ``theta_sweep`` launch: ``kind`` is
    ``"registers"``, ``"shared"`` or ``"scratch"``; ``code`` the C entry's
    path number; ``slots``/``stride`` the φ-row ring (slots of ``stride``
    bytes), ``meta_off`` where the staged token columns start and ``smem``
    the dynamic shared memory a CTA (bytes)."""
    kind: str
    code: int
    slots: int
    stride: int
    meta_off: int
    smem: int


def sweep_path(K: int, A: int, L: int, itemsize: int,
               phi_ptr: int) -> SweepPath:
    """The path of a launch at width K with A active topics (0: dense) over
    L token columns and φ of ``itemsize``-byte elements at address
    ``phi_ptr``: the register paths where the lanes, the staging buffers
    and a ring of two reductions' rows fit; else the wide path.  A plain
    function of its arguments (the CPU tests hold it)."""
    row = K * itemsize
    stride = -(-row // 16) * 16 + 16
    room = RING_BUDGET - 16 * L
    slots = min(MAX_SLOTS, max(room, 0) // stride)
    sched = 8 * K + 16 * SCHED_STAGE if A else 0
    if (K <= REG_MAX_K and A <= SCHED_STAGE and sched <= room
            and slots >= 2 * GROUP_ROWS[itemsize]):
        vec = row % 16 == 0 and phi_ptr % 16 == 0
        meta_off = -(-max(slots * stride, sched) // 16) * 16
        return SweepPath("registers", 0 if vec else 1, slots, stride,
                         meta_off, meta_off + 16 * L)
    if 3 * K * 4 <= SMEM_BUDGET:
        return SweepPath("shared", 2, 0, 0, 0, 3 * K * 4)
    return SweepPath("scratch", 3, 0, 0, 0, 0)


def doc_order(est_counts: torch.Tensor) -> torch.Tensor:
    """The order in which a launch's CTAs take the documents: by fit tokens
    (nonzero estimation counts), most first, ties by index.  (D,) int32 on
    the counts' device."""
    fit = (est_counts != 0).sum(1)
    return torch.sort(fit, descending=True, stable=True)[1].to(torch.int32)


def quantize_phi(phi_norm: torch.Tensor, phi_dtype: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize a normalised (W_s, K) φ block for read-only serving.

    Returns ``(values, scale)`` where ``scale`` is ``None`` except for
    int8, which uses symmetric per-row quantization: ``scale_w =
    max_k |φ_w(k)| / 127`` (1.0 for all-zero rows, e.g. vocab padding)
    and ``values = round(φ_w / scale_w)`` (round half to even) clipped to
    ±127.  The same values and scales as the JAX package's
    ``quantize_phi``.
    """
    if phi_dtype == "float32":
        return phi_norm, None
    if phi_dtype == "bfloat16":
        return phi_norm.to(torch.bfloat16), None
    if phi_dtype == "int8":
        amax = phi_norm.abs().amax(-1)
        scale = torch.where(amax > 0, amax / 127.0,
                            torch.ones_like(amax)).to(torch.float32)
        q = torch.round(phi_norm / scale[:, None])
        return q.clamp(-127, 127).to(torch.int8), scale
    raise ValueError(
        f"unknown phi_dtype {phi_dtype!r}; expected one of {PHI_DTYPES}"
    )


def dequantize_phi(values: torch.Tensor,
                   scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Invert :func:`quantize_phi` (the plain version's read path)."""
    out = values.to(torch.float32)
    if scale is not None:
        out = out * scale[:, None]
    return out


def word_lane_masks(phi: torch.Tensor, word_topics: torch.Tensor
                    ) -> torch.Tensor:
    """(W_s, A) active-topic ids → (W_s, K) {0,1} float lane masks."""
    mask = torch.zeros(phi.shape, dtype=torch.float32, device=phi.device)
    return mask.scatter_(1, word_topics.long(), 1.0)


def theta_sweep_reference(
    word_ids: torch.Tensor,     # (D, L) int32 — rows into phi
    est_counts: torch.Tensor,   # (D, L) float32 — estimation (80%) split
    ev_counts: torch.Tensor,    # (D, L) float32 — evaluation (20%) split
    theta: torch.Tensor,        # (D, K) float32 θ̂ statistics
    phi: torch.Tensor,          # (W_s, K) normalised φ: f32, bf16 or int8
    word_topics: Optional[torch.Tensor] = None,  # (W_s, A) int32
    phi_scale: Optional[torch.Tensor] = None,    # (W_s,) f32 int8 scales
    *,
    alpha_m1: float,
    num_sweeps: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`theta_sweep`, any device.

    A port of ``ops._infer_chunk_portable``: dequantize, gather the φ rows
    once, scan the fixed point, measure both splits' per-token
    log-predictive partials against the final θ̂.
    """
    K = theta.shape[-1]
    k_alpha = K * alpha_m1
    phi_read = dequantize_phi(phi, phi_scale)
    idx = word_ids.long()
    rows = phi_read[idx]                                   # (D, L, K)
    if word_topics is not None:
        rows_fit = rows * word_lane_masks(phi_read, word_topics)[idx]
    else:
        rows_fit = rows

    def normalize(theta):
        den = theta.sum(-1, keepdim=True) + k_alpha
        return (theta + alpha_m1) / den.clamp_min(1e-30)

    for _ in range(num_sweeps):
        num = normalize(theta)[:, None, :] * rows_fit      # (D, L, K)
        mu = num / num.sum(-1, keepdim=True).clamp_min(1e-30)
        theta = torch.einsum("dlk,dl->dk", mu, est_counts)
    lik = torch.einsum("dlk,dk->dl", rows, normalize(theta))
    ll = torch.log(lik.clamp_min(1e-30))                   # full support
    return theta, est_counts * ll, ev_counts * ll


def _launcher():
    from repro_torch.kernels import build

    lib = build.load("theta_sweep")
    fn = lib.theta_sweep_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, p, p, i, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        lib.theta_sweep_error_string.argtypes = [ctypes.c_int]
        lib.theta_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_args(word_ids, est_counts, ev_counts, theta, phi,
                     word_topics, phi_scale) -> None:
    dev = theta.device
    D, L = word_ids.shape
    K = theta.shape[1]
    want = [
        ("word_ids", word_ids, torch.int32, (D, L)),
        ("est_counts", est_counts, torch.float32, (D, L)),
        ("ev_counts", ev_counts, torch.float32, (D, L)),
        ("theta", theta, torch.float32, (D, K)),
    ]
    if word_topics is not None:
        want.append(("word_topics", word_topics, torch.int32,
                     (phi.shape[0], word_topics.shape[1])))
    if phi_scale is not None:
        want.append(("phi_scale", phi_scale, torch.float32,
                     (phi.shape[0],)))
    for name, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"theta_sweep: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"theta_sweep: {name} must be contiguous")
    if (phi.device != dev or phi.dtype not in _PHI_CODE or phi.ndim != 2
            or phi.shape[1] != K or not phi.is_contiguous()):
        raise ValueError(
            f"theta_sweep: phi must be a contiguous (W_s, {K}) float32, "
            f"bfloat16 or int8 tensor on {dev}, got {phi.dtype} "
            f"{tuple(phi.shape)} on {phi.device}"
        )
    if word_topics is not None and not 0 < word_topics.shape[1] <= K:
        raise ValueError("theta_sweep: word_topics needs 1 <= A <= K")


def theta_sweep(
    word_ids: torch.Tensor,     # (D, L) int32 — rows into phi
    est_counts: torch.Tensor,   # (D, L) float32 — estimation (80%) split
    ev_counts: torch.Tensor,    # (D, L) float32 — evaluation (20%) split
    theta: torch.Tensor,        # (D, K) float32 θ̂ statistics (carried)
    phi: torch.Tensor,          # (W_s, K) normalised φ: f32, bf16 or int8
    word_topics: Optional[torch.Tensor] = None,  # (W_s, A) int32: scheduled
    phi_scale: Optional[torch.Tensor] = None,    # (W_s,) f32: int8 scales
    *,
    alpha_m1: float,
    num_sweeps: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num_sweeps`` frozen-φ fixed-point sweeps + the eq. 21 phase.

    Returns ``(theta (D, K), est_ll (D, L), ev_ll (D, L))``.  CUDA tensors
    run the kernel (one launch, on the current stream, not synchronised);
    CPU tensors run :func:`theta_sweep_reference`.  Word ids must index
    rows of ``phi`` and ``word_topics`` must index topics: the kernel does
    not check either, ``ops.infer`` does.  The ids in a row of
    ``word_topics`` must be distinct.
    """
    if num_sweeps < 1:
        raise ValueError("num_sweeps must be >= 1")
    if phi.dtype == torch.int8 and phi_scale is None:
        raise ValueError("int8 phi requires phi_scale row scales")
    if theta.device.type == "cpu":
        return theta_sweep_reference(
            word_ids, est_counts, ev_counts, theta, phi, word_topics,
            phi_scale, alpha_m1=alpha_m1, num_sweeps=num_sweeps,
        )
    if theta.device.type != "cuda":
        raise ValueError(f"theta_sweep runs on cuda or cpu, not {theta.device}")
    _check_cuda_args(word_ids, est_counts, ev_counts, theta, phi,
                     word_topics, phi_scale)
    D, L = word_ids.shape
    K = theta.shape[1]
    theta_out = torch.empty_like(theta)
    est_ll = torch.empty((D, L), dtype=torch.float32, device=theta.device)
    ev_ll = torch.empty_like(est_ll)
    if D == 0:
        return theta_out, est_ll, ev_ll
    A = 0 if word_topics is None else word_topics.shape[1]
    path = sweep_path(K, A, L, phi.element_size(), phi.data_ptr())
    scratch = None
    if path.kind == "scratch":
        scratch = torch.empty((D, 3 * K), dtype=torch.float32,
                              device=theta.device)
    order = doc_order(est_counts)
    lib = _launcher()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.theta_sweep_launch(
            ptr(word_ids), ptr(est_counts), ptr(ev_counts), ptr(theta),
            ptr(phi), _PHI_CODE[phi.dtype], ptr(phi_scale), ptr(word_topics),
            A, ptr(theta_out), ptr(est_ll), ptr(ev_ll), ptr(scratch),
            ptr(order), path.code, path.slots, path.stride, path.meta_off,
            path.smem, D, L, K, num_sweeps, float(alpha_m1),
            float(K * alpha_m1),
            stream,
        )
    if rc != 0:
        msg = lib.theta_sweep_error_string(rc).decode()
        raise RuntimeError(f"theta_sweep kernel launch failed: {msg} ({rc})")
    theta_sweep.launches += 1
    return theta_out, est_ll, ev_ll


theta_sweep.launches = 0
