from repro_torch.sparse.docword import (
    DocWordMatrix,
    bucket_length,
    bucketize,
    localize_vocab,
)
from repro_torch.sparse.minibatch import (
    Minibatch,
    MinibatchStream,
    prefetch_iterator,
)

__all__ = ["DocWordMatrix", "Minibatch", "MinibatchStream", "bucket_length",
           "bucketize", "localize_vocab", "prefetch_iterator"]
