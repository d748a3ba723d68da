from repro_torch.sparse.docword import (
    DocWordMatrix,
    bucket_length,
    bucketize,
    localize_vocab,
)

__all__ = ["DocWordMatrix", "bucket_length", "bucketize", "localize_vocab"]
