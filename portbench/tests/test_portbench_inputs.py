"""The seeded inputs: the same seed gives the same documents and φ̂, another
seed other ones; the cut keeps a document's highest-count words."""
import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.tests.tiny import TINY

CFG = dict(TINY, zipf_exponent=1.1)


def phi(seed):
    return torch.cat([b for _, b in inputs.phi_blocks(
        CFG, seed, torch.device("cpu"), block_rows=64)])


def test_phi_is_a_function_of_the_seed():
    a, b, c = phi(2**31 + 7), phi(2**31 + 7), phi(3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (CFG["vocab_size"], CFG["num_topics"])
    # each row's mass on distinct topics, summing to the Zipf envelope
    assert int((a[0] > 0).sum()) == CFG["phi_topics_per_word"]
    assert float(a.double().sum()) == pytest.approx(CFG["phi_tokens"],
                                                    rel=1e-5)


def test_documents_are_a_function_of_the_seed():
    src = inputs.DocSource(CFG, 11)
    a, b = src.docs(4, 50), inputs.DocSource(CFG, 11).docs(4, 50)
    c = inputs.DocSource(CFG, 12).docs(4, 50)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.words, c.words)
    lens = np.diff(a.indptr)
    assert lens.min() >= 1 and lens.max() <= CFG["bucket_len"]
    assert a.counts.sum() + a.tokens_cut == a.tokens_drawn


def test_the_cut_keeps_the_highest_counts():
    cfg = dict(CFG, bucket_len=3, doc_tokens=[60, 60], vocab_size=40)
    docs = inputs.DocSource(cfg, 1).docs(0, 20)
    assert docs.tokens_cut > 0
    assert np.diff(docs.indptr).max() == 3


def test_layout_and_local_vocabulary():
    docs = inputs.DocSource(CFG, 3).docs(0, 10)
    ids, counts = inputs.dense_layout(docs, CFG["bucket_len"])
    assert counts.sum() == docs.counts.sum()
    vocab, local = inputs.localize(ids)
    np.testing.assert_array_equal(vocab[local], ids)
    for i in range(10):
        w, c = docs.doc(i)
        np.testing.assert_array_equal(ids[i, :len(w)], w)
        assert (counts[i, len(w):] == 0).all()
