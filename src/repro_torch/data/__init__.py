from repro_torch.data.synthetic import (
    synthetic_lda_corpus,
    trained_like_phi_blocks,
)

__all__ = ["synthetic_lda_corpus", "trained_like_phi_blocks"]
