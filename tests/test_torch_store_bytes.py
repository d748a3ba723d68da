"""The port store's Table 5 helpers against the JAX package's.

``ParameterStore.rows_for_bytes`` (a buffer size in bytes as W* rows) and
``ParameterStore.buffer_bytes`` (the bytes the hot-row buffer holds): the
port copy of ``tests/test_streaming_store.py::test_rows_for_bytes``, the
two packages' answers for the same sizes and dtypes, and both stores'
``buffer_bytes`` after the same seeded reads and writes, in float32 and
bf16.
"""
import ml_dtypes
import numpy as np
import pytest

from repro.core.streaming import ParameterStore as JStore
from repro_torch.core import ParameterStore


def test_rows_for_bytes():
    assert ParameterStore.rows_for_bytes(1000, 4_000_000) == 1000


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("K,nbytes", [(1000, 4_000_000), (10_000, 1 << 30),
                                      (7, 999), (64, 0), (8, 2.5e6)])
def test_rows_for_bytes_matches_the_jax_store(K, nbytes, dtype):
    want = JStore.rows_for_bytes(K, nbytes, dtype)
    assert ParameterStore.rows_for_bytes(K, nbytes, dtype) == want
    assert want == int(nbytes // (K * np.dtype(dtype).itemsize))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_buffer_bytes_matches_the_jax_store(tmp_path, dtype):
    K, W, buf = 6, 80, 24
    stores = [cls(str(tmp_path / name), num_topics=K, vocab_capacity=W,
                  buffer_rows=buf, dtype=dtype)
              for cls, name in ((JStore, "jax"), (ParameterStore, "port"))]
    assert [s.buffer_bytes() for s in stores] == [0, 0]
    rng = np.random.default_rng(4)
    itemsize = np.dtype(dtype).itemsize
    for step in range(10):
        ids = rng.choice(W, size=int(rng.integers(3, 15)), replace=False)
        for s in stores:
            rows = s.fetch_rows(ids)
            if step % 2:
                s.write_rows(ids, np.asarray(rows, np.float32) + 1.0)
        got = [s.buffer_bytes() for s in stores]
        assert got[0] == got[1] == stores[1].resident_rows() * K * itemsize
    assert 0 < got[1] <= buf * K * itemsize
