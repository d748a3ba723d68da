"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips on a host without a CUDA
device (the decision is made inside the test).  On a GPU host run them without the repository's conftest, which
imports JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes are odd on purpose: K not a multiple of the 1024-thread CTA, zero
count columns, A above the warp width, and K = 50,000 (``bigmodel``), where
the per-document state leaves shared memory for the global scratch.
Tolerances are chip_smoke.py's: float32 sums over K taken in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.theta_sweep import (
    SMEM_BUDGET,
    quantize_phi,
    theta_sweep,
    theta_sweep_reference,
    word_lane_masks,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(D, L, K, W, A, dev, seed=0):
    rng = np.random.default_rng(seed)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    est = rng.integers(0, 4, (D, L)).astype(np.float32)   # zero columns
    ev = rng.integers(0, 2, (D, L)).astype(np.float32)
    est[:, -2:] = 0.0                                      # padded tail
    ev[:, -1] = 0.0
    phi = rng.gamma(0.3, 1.0, (W, K)).astype(np.float32)
    phi /= phi.sum(0, keepdims=True)
    theta = rng.gamma(1.0, 1.0, (D, K)).astype(np.float32)
    wt = np.stack([rng.choice(K, A, replace=False) for _ in range(W)]) \
        if A else None
    t = lambda x: None if x is None else torch.from_numpy(x).to(dev)  # noqa
    return t(wid), t(est), t(ev), t(theta), t(phi), \
        (None if wt is None else t(wt.astype(np.int32)))


def _check(got, want):
    for name, a, b, atol in zip(("theta", "est_ll", "ev_ll"), got, want,
                                (1e-4, 1e-3, 1e-3)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=name)


@pytest.mark.parametrize("D,L,K,W,A", [
    (1, 3, 7, 5, 0),
    (5, 17, 1000, 40, 0),
    (9, 8, 1500, 30, 3),
    (4, 6, 2048, 12, 40),
])
@pytest.mark.parametrize("phi_dtype", ["float32", "bfloat16", "int8"])
def test_kernel_matches_plain(cuda, D, L, K, W, A, phi_dtype):
    wid, est, ev, theta, phi, wt = _inputs(D, L, K, W, A, cuda, seed=K)
    q, scale = quantize_phi(phi, phi_dtype)
    kw = dict(alpha_m1=0.01, num_sweeps=4)
    before = theta_sweep.launches
    got = theta_sweep(wid, est, ev, theta, q, wt, scale, **kw)
    torch.cuda.synchronize()
    assert theta_sweep.launches == before + 1
    _check(got, theta_sweep_reference(wid, est, ev, theta, q, wt, scale,
                                      **kw))


def test_global_scratch_path(cuda):
    """K = 50,000 (bigmodel): 3·K floats exceed shared memory, the kernel
    keeps each document's state in a global scratch and agrees all the
    same."""
    K = 50_000
    assert 3 * K * 4 > SMEM_BUDGET
    wid, est, ev, theta, phi, _ = _inputs(6, 9, K, 20, 0, cuda, seed=1)
    kw = dict(alpha_m1=0.01, num_sweeps=3)
    got = theta_sweep(wid, est, ev, theta, phi, **kw)
    torch.cuda.synchronize()
    _check(got, theta_sweep_reference(wid, est, ev, theta, phi, **kw))


def test_bitwise_repeatable_and_batch_invariant(cuda):
    wid, est, ev, theta, phi, _ = _inputs(12, 10, 3000, 50, 0, cuda, seed=2)
    kw = dict(alpha_m1=0.01, num_sweeps=5)
    a = theta_sweep(wid, est, ev, theta, phi, **kw)
    b = theta_sweep(wid, est, ev, theta, phi, **kw)
    part = theta_sweep(wid[3:7].contiguous(), est[3:7].contiguous(),
                       ev[3:7].contiguous(), theta[3:7].contiguous(), phi,
                       **kw)
    for x, y, z in zip(a, b, part):
        assert torch.equal(x, y)
        assert torch.equal(x[3:7], z)


def test_zero_count_documents_inert(cuda):
    wid, est, ev, theta, phi, _ = _inputs(4, 6, 700, 10, 0, cuda, seed=3)
    est[1] = 0.0
    ev[1] = 0.0
    th, e, v = theta_sweep(wid, est, ev, theta, phi, alpha_m1=0.01,
                           num_sweeps=2)
    assert float(th[1].abs().sum()) == 0.0
    assert float(e[1].abs().sum()) == 0.0 and float(v[1].abs().sum()) == 0.0


def test_wrapper_refuses_bad_operands(cuda):
    wid, est, ev, theta, phi, _ = _inputs(2, 3, 16, 4, 0, cuda)
    with pytest.raises(ValueError, match="word_ids"):
        theta_sweep(wid.long(), est, ev, theta, phi, alpha_m1=0.01,
                    num_sweeps=1)
    with pytest.raises(ValueError, match="phi"):
        theta_sweep(wid, est, ev, theta, phi.double(), alpha_m1=0.01,
                    num_sweeps=1)
    with pytest.raises(ValueError, match="contiguous"):
        theta_sweep(wid, est, ev, theta.t().contiguous().t(), phi,
                    alpha_m1=0.01, num_sweeps=1)


@pytest.mark.parametrize("name,value", [("word_ids", 40), ("word_ids", -3),
                                        ("word_topics", 1000)])
def test_infer_refuses_out_of_range_indices(cuda, name, value):
    """The kernel reads φ rows and writes θ̂ lanes at these values without a
    bound check; ops.infer refuses them before any launch."""
    wid, est, ev, theta, phi, wt = _inputs(5, 7, 1000, 40, 4, cuda, seed=5)
    bad = {"word_ids": wid, "word_topics": wt}[name]
    bad[2, 1] = value
    before = theta_sweep.launches
    with pytest.raises(ops.ContractError, match=name):
        ops.infer(wid, est, theta, phi, alpha_m1=0.01, ev_counts=ev,
                  word_topics=wt, max_sweeps=2, check_every=2, device="cuda")
    assert theta_sweep.launches == before


def test_lane_masks_match_kernel_support(cuda):
    """The plain version's lane masks mark exactly the word_topics lanes."""
    _, _, _, _, phi, wt = _inputs(2, 3, 64, 8, 5, cuda)
    m = word_lane_masks(phi, wt)
    assert int(m.sum()) == 8 * 5
    assert bool((m.gather(1, wt.long()) == 1).all())
