import os
import sys

# tests run on the single real CPU device (the 512-device override is
# exclusively for launch/dryrun.py)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import numpy as np
import pytest

from repro.core import LDAConfig, MinibatchData
from repro.data import synthetic_lda_corpus
from repro.sparse import MinibatchStream

jax.config.update("jax_enable_x64", False)

# Concurrency harness hook: the CI `concurrency` job lowers the GIL switch
# interval (e.g. REPRO_SWITCH_INTERVAL=0.0001) so the threaded suites see
# far more preemption points per run than the 5 ms default allows.
_si = os.environ.get("REPRO_SWITCH_INTERVAL")
if _si:
    sys.setswitchinterval(float(_si))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (process-pool chaos etc.); "
        "skipped unless REPRO_RUN_SLOW=1",
    )
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel of the PyTorch port; skipped on a host "
        "without a CUDA device",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("REPRO_RUN_SLOW"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: set REPRO_RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def tiny_corpus():
    corpus, true_phi = synthetic_lda_corpus(
        96, 240, 6, mean_doc_len=50, seed=7
    )
    return corpus, true_phi


@pytest.fixture(scope="session")
def tiny_cfg():
    # iem_blocks left at the column-serial default (0 → B = L): the coarse
    # 4-block setting folds too rarely and loses the §2.2 IEM-vs-BEM ordering.
    return LDAConfig(num_topics=6, vocab_size=240, max_sweeps=16)


@pytest.fixture(scope="session")
def tiny_batch(tiny_corpus):
    import jax.numpy as jnp

    corpus, _ = tiny_corpus
    stream = MinibatchStream(corpus, 48, seed=0, epochs=1)
    mb = next(iter(stream))
    return MinibatchData(jnp.asarray(mb.word_ids), jnp.asarray(mb.counts))
