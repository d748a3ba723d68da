"""foem-lda — the paper's own architecture: LDA trained with FOEM.

Cells mirror the paper's experimental regimes (Table 4 / §4.2), the same as
``repro.configs.foem_lda``:
  * ``stream_1k``   — PUBMED-scale stream: D_s=1024, K=10^4, W=141,043
  * ``stream_4k``   — larger minibatch (Fig. 8 sweep upper end)
  * ``bigmodel``    — big-model regime: K=5·10^4, W=5·10^5
                      (paper §1 task 2-4: ≥10^9 parameters)

``minibatch_docs`` = minibatch documents, ``bucket_len`` = bucket length L
(distinct words per doc).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.types import LDAConfig


@dataclasses.dataclass(frozen=True)
class LDAShapeConfig:
    name: str
    minibatch_docs: int    # D_s
    bucket_len: int        # L (distinct words per doc, bucketed)
    num_topics: int        # K
    vocab_size: int        # W


LDA_SHAPES: Tuple[LDAShapeConfig, ...] = (
    LDAShapeConfig("stream_1k", minibatch_docs=1024, bucket_len=128,
                   num_topics=10_000, vocab_size=141_043),
    LDAShapeConfig("stream_4k", minibatch_docs=4096, bucket_len=128,
                   num_topics=10_000, vocab_size=141_043),
    LDAShapeConfig("bigmodel", minibatch_docs=512, bucket_len=128,
                   num_topics=50_000, vocab_size=500_000),
)

NAME = "foem-lda"
FAMILY = "mixture"


def lda_shape(name: str) -> LDAShapeConfig:
    """The ``LDA_SHAPES`` entry called ``name``."""
    for shape in LDA_SHAPES:
        if shape.name == name:
            return shape
    raise KeyError(f"unknown LDA shape {name!r}; have "
                   f"{[s.name for s in LDA_SHAPES]}")


def lda_config(shape: LDAShapeConfig, active_topics: int = 16) -> LDAConfig:
    return LDAConfig(
        num_topics=shape.num_topics,
        vocab_size=shape.vocab_size,
        alpha_m1=0.01,
        beta_m1=0.01,
        max_sweeps=32,
        iem_blocks=0,   # column-serial folds (B = L): keeps T_IEM < T_BEM

        active_topics=active_topics,
        rho_mode="accumulate",
    )
