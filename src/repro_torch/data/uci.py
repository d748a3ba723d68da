"""UCI bag-of-words loader — the paper's corpora format (ENRON/WIKI/NYTIMES/
PUBMED are distributed as ``docword.<name>.txt[.gz]`` + ``vocab.<name>.txt``).

Format:
    line 1: D        (number of documents)
    line 2: W        (vocabulary size)
    line 3: NNZ      (number of non-zero counts)
    lines 4+: docID wordID count      (both IDs 1-based)

Supports chunked streaming (the PUBMED file is 3.6 GB uncompressed): pass
``max_docs`` to cut the head off a big corpus, or use ``iter_docword`` to
stream documents without materialising the whole matrix.

A numpy-only copy of ``repro.data.uci`` on the port's own
``DocWordMatrix``: the same file gives the same arrays in both packages.
"""
from __future__ import annotations

import gzip
import io
from typing import IO, Iterator, List, Optional

import numpy as np

from repro_torch.sparse.docword import DocWordMatrix


def _open(path: str) -> IO[str]:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def load_docword(path: str, *, max_docs: Optional[int] = None) -> DocWordMatrix:
    """Load a UCI docword file into a DocWordMatrix (document-major CSR).

    Rows must be grouped by docID (the UCI files are sorted); word ids are
    converted to 0-based.  Documents with no line are empty rows, up to D
    (or ``max_docs``).
    """
    with _open(path) as f:
        D = int(f.readline())
        W = int(f.readline())
        int(f.readline())                      # NNZ (unused; we count)
        indptr: List[int] = [0]
        wids: List[int] = []
        cnts: List[float] = []
        cur_doc = 1
        n = 0
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            d, w, c = int(parts[0]), int(parts[1]), float(parts[2])
            while cur_doc < d:                 # close empty/finished docs
                indptr.append(n)
                cur_doc += 1
                if max_docs is not None and cur_doc > max_docs:
                    break
            if max_docs is not None and d > max_docs:
                break
            wids.append(w - 1)
            cnts.append(c)
            n += 1
        last = min(D, max_docs) if max_docs is not None else D
        while cur_doc <= last:
            indptr.append(n)
            cur_doc += 1
    return DocWordMatrix(
        indptr=np.asarray(indptr, np.int64),
        word_ids=np.asarray(wids, np.int32),
        counts=np.asarray(cnts, np.float32),
        vocab_size=W,
    )


def iter_docword(
    path: str, docs_per_chunk: int = 4096,
) -> Iterator[DocWordMatrix]:
    """Stream a UCI docword file as a sequence of DocWordMatrix chunks —
    the lifelong-learning ingestion path (constant memory in D).  Documents
    with no line do not appear; a chunk holds ``docs_per_chunk`` documents,
    the last one the rest."""
    with _open(path) as f:
        int(f.readline())
        W = int(f.readline())
        int(f.readline())
        indptr: List[int] = [0]
        wids: List[int] = []
        cnts: List[float] = []
        cur_doc: Optional[int] = None
        docs_in_chunk = 0

        def flush() -> DocWordMatrix:
            return DocWordMatrix(
                indptr=np.asarray(indptr, np.int64),
                word_ids=np.asarray(wids, np.int32),
                counts=np.asarray(cnts, np.float32),
                vocab_size=W,
            )

        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            d, w, c = int(parts[0]), int(parts[1]), float(parts[2])
            if cur_doc is None:
                cur_doc = d
            if d != cur_doc:
                indptr.append(len(wids))
                docs_in_chunk += 1
                cur_doc = d
                if docs_in_chunk >= docs_per_chunk:
                    yield flush()
                    indptr, wids, cnts = [0], [], []
                    docs_in_chunk = 0
            wids.append(w - 1)
            cnts.append(c)
        if wids or docs_in_chunk:
            indptr.append(len(wids))
            yield flush()


def load_vocab(path: str) -> List[str]:
    """The vocabulary file's words, one a line, blank lines dropped."""
    with _open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]
