"""Port's active-set selection vs ``jax.lax.top_k``, ties included.

``lax.top_k`` puts the lower index first among equal values; the port's
``select_active_topics`` must pick the same ids in the same order on rows
with ties — all-equal scheduler rows, all-zero residual rows, repeated
values — or scheduled fits would restrict different lanes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scheduling import select_active_topics as j_select
from repro.core.types import SchedulerState
from repro_torch.core.perplexity import serving_active_topics
from repro_torch.core.scheduling import select_active_topics


def _rows(kind, W, K, rng):
    if kind == "all_equal":
        return np.full((W, K), 3.0e37, np.float32)   # init_scheduler rows
    if kind == "all_zero":
        return np.zeros((W, K), np.float32)
    if kind == "repeats":
        return rng.integers(0, 3, (W, K)).astype(np.float32)
    r = rng.random((W, K)).astype(np.float32)
    r[::3] = 0.0                                     # absent-word rows
    r[1::3, : K // 2] = r[1::3, K // 2 - 1: K // 2]  # runs of equal values
    return r


@pytest.mark.parametrize("kind", ["all_equal", "all_zero", "repeats",
                                  "mixed"])
@pytest.mark.parametrize("A,shards", [(1, 0), (4, 0), (8, 2), (16, 0)])
def test_select_active_topics_matches_lax_top_k(kind, A, shards):
    rng = np.random.default_rng(A + 7 * shards)
    W, K = 24, 16
    r = _rows(kind, W, K, rng)
    want = np.asarray(j_select(
        SchedulerState(r_wk=jnp.asarray(r), r_w=jnp.zeros(W)),
        A, shards))
    got = select_active_topics(torch.from_numpy(r), A, shards)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_active_topics_ranks_by_phi_mass():
    """Serving sets are the top-A φ_w(k), lower topic id first on ties."""
    phi = torch.tensor([[0.1, 0.5, 0.5, 0.2],
                        [0.0, 0.0, 0.0, 0.0],
                        [0.3, 0.1, 0.3, 0.3]])
    got = serving_active_topics(phi, 2)
    np.testing.assert_array_equal(got.numpy(), [[1, 2], [0, 1], [0, 2]])
