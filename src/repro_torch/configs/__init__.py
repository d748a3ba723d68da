from repro_torch.configs.foem_lda import (
    LDA_SHAPES,
    LDAShapeConfig,
    lda_config,
    lda_shape,
)

__all__ = ["LDA_SHAPES", "LDAShapeConfig", "lda_config", "lda_shape"]
