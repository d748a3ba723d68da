from repro_torch.data.synthetic import (
    synthetic_lda_corpus,
    trained_like_phi_blocks,
)
from repro_torch.data.uci import iter_docword, load_docword, load_vocab

__all__ = ["iter_docword", "load_docword", "load_vocab",
           "synthetic_lda_corpus", "trained_like_phi_blocks"]
