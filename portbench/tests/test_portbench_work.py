"""The work counts on shapes small enough to count by hand."""
import pytest

from portbench import readers
from portbench.work import counts, peaks


def test_dense_sweep_by_hand():
    # 2 entries, 1 document, 2 rows, K = 3
    flops, nbytes = counts.dense_sweep(2, 1, 2, 3)
    assert flops == 2 * 3 * 19
    assert nbytes == 4 * (3 * 2 * 3 + 2 * 1 * 3 + 2 * 2 * 3 + 2 * 3 + 2 * 2)


def test_scheduled_sweep_counts_active_lanes_only():
    f_a, b_a = counts.scheduled_sweep(10, 2, 5, 1000, 4)
    f_b, b_b = counts.scheduled_sweep(10, 2, 5, 2000, 4)
    assert f_a == f_b == 10 * 4 * 21
    assert b_b - b_a == 2 * 1000 * 4       # only φ̂(k) grows with K


def test_theta_chunk_by_hand():
    flops, nbytes = counts.theta_chunk(n=3, docs=1, rows=2, K=2, sweeps=10)
    assert flops == 10 * (3 * 2 * 5 + 1 * 2 * 2) + 3 * 2 * 2 + 1 * 2 * 2
    assert nbytes == 4 * (2 * 2 + 2 * 1 * 2 + 2 * 3 + 3)


def test_bound_is_the_larger_term():
    assert peaks.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(67e12, 6.7e12) == pytest.approx(2.0)


@pytest.mark.parametrize("sweeps,expect", [(32, (2, 30, 4)), (20, (2, 18, 3)),
                                           (10, (2, 8, 2))])
def test_sweeps_by_kind(sweeps, expect):
    cfg = {"warmup_sweeps": 2, "active_topics": 16, "ppl_check_every": 10}
    assert readers.sweeps_by_kind({"sweeps": sweeps}, cfg) == expect


def test_step_work_adds_its_parts():
    cfg = {"warmup_sweeps": 2, "active_topics": 4, "ppl_check_every": 10,
           "num_topics": 50}
    step = {"sweeps": 10, "n": 30, "docs": 4, "rows": 12}
    f, b = readers.step_work(step, cfg)
    d = counts.dense_sweep(30, 4, 12, 50)
    s = counts.scheduled_sweep(30, 4, 12, 50, 4)
    assert f > 2 * d[0] + 8 * s[0] and b > 2 * d[1] + 8 * s[1]
