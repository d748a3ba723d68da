"""The port's UCI bag-of-words loader (``repro_torch.data.uci``) against the
JAX package's (``repro.data.uci``).

* The five cases of ``tests/test_data_uci.py`` against the port; the last
  streams the loaded corpus through the port's ``foem.foem_step`` on the
  CPU.
* Equality with the JAX package's loader on the same files, array by array
  and bit for bit (``np.testing.assert_array_equal`` on indptr, word ids and
  counts, which are integers or integer-valued floats parsed the same way):
  the sample, its ``.gz`` twin, ``max_docs=2``, a file with empty and
  trailing-empty documents, and ``iter_docword`` in chunks of 1, 2 and 4.
"""
import gzip

import numpy as np
import pytest
import torch

from repro.data import uci as juci
from repro_torch.data import iter_docword, load_docword, load_vocab

SAMPLE = """\
4
6
7
1 1 2
1 3 1
2 2 5
3 1 1
3 4 2
3 6 1
4 5 3
"""

# documents 2, 4 and 6-7 have no line: empty in the middle, at the end
HOLES = """\
7
9
6
1 2 1
1 9 4
3 1 2
3 5 1
5 3 7
5 8 1
"""


def _write(tmp_path, text=SAMPLE, gz=False, name="dw"):
    p = tmp_path / (f"{name}.txt.gz" if gz else f"{name}.txt")
    if gz:
        with gzip.open(p, "wt") as f:
            f.write(text)
    else:
        p.write_text(text)
    return str(p)


def _equal(got, want):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.word_ids, want.word_ids)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.indptr.dtype == want.indptr.dtype
    assert got.word_ids.dtype == want.word_ids.dtype
    assert got.counts.dtype == want.counts.dtype
    assert got.vocab_size == want.vocab_size


# ---------------------------------------------------------------------------
# The JAX package's cases, on the port
# ---------------------------------------------------------------------------

def test_load_docword_roundtrip(tmp_path):
    mat = load_docword(_write(tmp_path))
    assert mat.num_docs == 4 and mat.vocab_size == 6 and mat.nnz == 7
    dense = mat.to_dense()
    assert dense[0, 0] == 2 and dense[0, 2] == 1
    assert dense[1, 1] == 5
    assert dense[2, 5] == 1 and dense[3, 4] == 3
    assert mat.ntokens() == 15


def test_load_docword_gz_and_max_docs(tmp_path):
    mat = load_docword(_write(tmp_path, gz=True), max_docs=2)
    assert mat.num_docs == 2
    assert mat.to_dense()[1, 1] == 5


def test_iter_docword_chunks(tmp_path):
    chunks = list(iter_docword(_write(tmp_path), docs_per_chunk=2))
    assert sum(c.num_docs for c in chunks) == 4
    total = sum(c.ntokens() for c in chunks)
    assert total == 15


def test_load_vocab(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("alpha\nbeta\n\ngamma\n")
    assert load_vocab(str(p)) == ["alpha", "beta", "gamma"]


def test_stream_through_trainer(tmp_path):
    """UCI chunks feed the port's MinibatchStream/FOEM path end to end."""
    from repro_torch.core import GlobalStats, LDAConfig, MinibatchData, foem
    from repro_torch.sparse import MinibatchStream

    mat = load_docword(_write(tmp_path))
    cfg = LDAConfig(num_topics=3, vocab_size=6, max_sweeps=6, iem_blocks=1)
    stream = MinibatchStream(mat, 2, seed=0, epochs=1)
    stats = GlobalStats(np.zeros((6, 3), np.float32),
                        np.zeros(3, np.float32), np.int32(0))
    steps = 0
    for mb in stream:
        batch = MinibatchData(mb.word_ids, mb.counts)
        stats, _, diag = foem.foem_step(torch.Generator().manual_seed(0),
                                        batch, stats, cfg, device="cpu")
        steps += 1
    assert steps == 2 and int(stats.step) == 2
    assert np.isfinite(float(diag.final_train_ppl))
    assert float(stats.phi_k.sum()) == pytest.approx(15.0, rel=1e-5)


# ---------------------------------------------------------------------------
# The same arrays as the JAX package's loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,gz,max_docs", [
    (SAMPLE, False, None), (SAMPLE, True, None), (SAMPLE, False, 2),
    (SAMPLE, True, 2), (SAMPLE, False, 9), (HOLES, False, None),
    (HOLES, True, 4), (HOLES, False, 2)])
def test_load_docword_matches_jax(tmp_path, text, gz, max_docs):
    path = _write(tmp_path, text, gz)
    got = load_docword(path, max_docs=max_docs)
    _equal(got, juci.load_docword(path, max_docs=max_docs))
    D = int(text.split()[0])
    assert got.num_docs == (D if max_docs is None else min(D, max_docs))


def test_empty_documents_close_by_indptr(tmp_path):
    mat = load_docword(_write(tmp_path, HOLES))
    assert mat.num_docs == 7
    lens = np.diff(mat.indptr).tolist()
    assert lens == [2, 0, 2, 0, 2, 0, 0]     # holes and the trailing pair
    np.testing.assert_array_equal(mat.doc(2)[0], [0, 4])   # 0-based ids


@pytest.mark.parametrize("text", [SAMPLE, HOLES])
@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_iter_docword_matches_jax(tmp_path, text, chunk):
    path = _write(tmp_path, text)
    got = list(iter_docword(path, docs_per_chunk=chunk))
    want = list(juci.iter_docword(path, docs_per_chunk=chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal(g, w)


def test_load_vocab_matches_jax_gz(tmp_path):
    p = tmp_path / "vocab.txt.gz"
    with gzip.open(p, "wt") as f:
        f.write("  one\ntwo  \n\n\nthree\n")
    assert load_vocab(str(p)) == juci.load_vocab(str(p)) == [
        "one", "two", "three"]
