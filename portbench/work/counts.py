"""Operations and HBM bytes that the LDA work needs, counted from its inputs.

The rule (the benchmark's, and the roofline's): each input byte is read
once and each output byte written once, and the work is what these inputs
need, whatever layout or kernel implements it.  So a count uses

* ``n``: the real (document, word) entries, those with a count; padding
  slots of a bucketed (D, L) layout are not work;
* ``docs``: the documents with at least one entry; ``rows``: the distinct
  words of those entries (the W_s rows touched);
* the sweeps run, by kind: a dense sweep works on all K topics of an
  entry, a scheduled sweep on its A active topics (every entry is active:
  λ_w = 1).

Floats are float32 (4 bytes), ids and counts 4 bytes each.  Where the
work depends on data the count cannot see (the θ̂ lanes a scheduled sweep
touches), it takes the least those inputs need, so a share of the
roofline computed from it errs low, never high.

Against ``repro_torch/launch/roofline.py`` (``lda_model_flops``,
``lda_step_bytes``), whose arithmetic this replaces for the benchmark:
it counts the padded D_s·L slots; a fixed 12 sweeps at 16 topics; and the
whole W×K φ̂ read and written twice a step, where a streaming step touches
only its W_s rows.
"""
from __future__ import annotations

from typing import Tuple

F = 4  # bytes of a float32, an int32 id or a float32 count

#: FLOPs a (entry, topic) lane of a sweep: x·μ_old, three subtractions of
#: it (θ̂, φ̂ row, φ̂(k)), +α, +β, ×, +W(β−1), ÷ (eq. 13), the Σ_k and ÷ of
#: the normalisation, x·μ_new − x·μ_old, three folds (θ̂, row, φ̂(k)) and
#: the eq. 36 residual x·|Δμ| (3).
SWEEP_LANE_FLOPS = 19
#: a scheduled lane adds the eq. 38 renormalisation: the old mass's sum
#: and its product.
SCHED_LANE_FLOPS = SWEEP_LANE_FLOPS + 2
#: FLOPs an entry-lane of eq. 3's data term: φ by eq. 10 (+β, ÷) and the
#: product's multiply-add.
LOGLIK_LANE_FLOPS = 4
#: FLOPs a document-lane of eq. 9 (+α, ÷).
NORM_LANE_FLOPS = 2
#: FLOPs an entry-lane of a frozen-φ θ sweep: θ_d(k)·φ_w(k), Σ_k, ÷, and
#: the fold x·μ into θ̂ (2).
THETA_LANE_FLOPS = 5

Work = Tuple[float, float]      # (FLOPs, bytes)


def add(*works: Work) -> Work:
    return (sum(w[0] for w in works), sum(w[1] for w in works))


def scale(work: Work, times: float) -> Work:
    return (work[0] * times, work[1] * times)


def dense_sweep(n: int, docs: int, rows: int, K: int) -> Work:
    """One dense column-serial sweep (``gs_sweep``): μ read, μ_new and the
    residual written, θ̂ and the rows read and written, φ̂(k) read and
    written, the ids and counts read."""
    flops = float(n) * K * SWEEP_LANE_FLOPS
    nbytes = (3 * n * K + 2 * docs * K + 2 * rows * K + 2 * K + 2 * n) * F
    return flops, float(nbytes)


def scheduled_sweep(n: int, docs: int, rows: int, K: int, A: int) -> Work:
    """One scheduled sweep (``scheduled_sweep``) on A lanes an entry: the
    active lanes of μ read and written and their residual written, each
    word's A topic ids read, the rows' active lanes read and written, at
    least A lanes of each document's θ̂ read and written, φ̂(k) read and
    written, the ids and counts read."""
    flops = float(n) * A * SCHED_LANE_FLOPS
    nbytes = (3 * n * A + rows * A + 2 * rows * A + 2 * docs * A + 2 * K
              + 2 * n) * F
    return flops, float(nbytes)


def loglik(n: int, docs: int, rows: int, K: int) -> Work:
    """The stop rule's eq. 3 data term after a sweep: θ̂, the rows and
    φ̂(k) read."""
    flops = float(n) * K * LOGLIK_LANE_FLOPS + docs * K * NORM_LANE_FLOPS
    return flops, float((docs * K + rows * K + K + 2 * n) * F)


def step_init(n: int, docs: int, rows: int, K: int) -> Work:
    """A step's start: the rows copied in, μ₀ drawn and normalised, and
    folded into θ̂₀ and into the rows and φ̂(k) (x·μ₀, Σ)."""
    flops = float(n) * K * (2 + 2 + 2)
    nbytes = (rows * K            # rows written by the host copy
              + n * K             # μ₀ written
              + n * K             # μ₀ read by the folds
              + docs * K          # θ̂₀ written
              + 2 * rows * K      # rows read and written by the fold
              + 2 * K) * F
    return flops, float(nbytes)


def scheduler_refresh(rows: int, K: int, A: int) -> Work:
    """Before a scheduled sweep, each word's top-A topics by residual: the
    (W_s, K) residual read; after it the A lanes replaced."""
    return float(rows) * K, float((rows * K + 2 * rows * A) * F)


def step_end(rows: int, K: int) -> Work:
    """A step's end: the rows copied out and the φ̂(k) change summed."""
    return float(rows) * K * 2, float(2 * rows * K * F)


def theta_chunk(n: int, docs: int, rows: int, K: int, sweeps: int) -> Work:
    """One ``theta_sweep`` call: ``sweeps`` frozen-φ sweeps and the
    per-entry log-likelihood after them.  The normalised rows, θ̂ in and
    the ids and counts read once; θ̂ and the per-entry partials written."""
    flops = (float(sweeps) * (n * K * THETA_LANE_FLOPS
                              + docs * K * NORM_LANE_FLOPS)
             + n * K * 2 + docs * K * NORM_LANE_FLOPS)
    nbytes = (rows * K + 2 * docs * K + 2 * n + n) * F
    return flops, float(nbytes)


def launch_init(n: int, docs: int, rows: int, K: int) -> Work:
    """A serving launch's start: the rows copied in and normalised (eq.
    10), each document's μ₀ drawn, normalised and folded into θ̂₀."""
    flops = float(rows) * K * 2 + float(n) * K * 4
    nbytes = (rows * K + 2 * rows * K + 2 * n * K + docs * K) * F
    return flops, float(nbytes)


def launch_end(docs: int, K: int) -> Work:
    """θ by eq. 9 and copied out."""
    return float(docs) * K * NORM_LANE_FLOPS, float(3 * docs * K * F)
