"""Plain NumPy reference scorer: the query semantics written out once.

Reads the index file directly, hashes every query window with the NumPy
XXH64 (core/xxh64.py), ANDs the h rows of each term with
``np.bitwise_and``, expands the bits with ``np.unpackbits`` and sums per
document. It shares no code with the scoring backends (no device program,
no native library, no row padding or packing), so it is the oracle they are
checked against in the tests and in ``chip_smoke.py``. Slow by design:
score a handful of queries with it.

Semantics (reference: cobs/query/classic_search.cpp:66-202):

- a query of length L has L - k + 1 terms; a document's score is the number
  of terms whose h Bloom rows all have the document's bit set;
- the threshold keeps scores >= ceil(threshold * (L - k + 1));
- results are ordered by (score desc, document index asc) and cut to
  num_results (0 = all).
"""

import math

import numpy as np

from cobs_tpu.core.canonical import canonicalize_batch
from cobs_tpu.core.xxh64 import xxh64_multi_seed
from cobs_tpu.fmt import classic as fmt_classic
from cobs_tpu.fmt import compact as fmt_compact
from cobs_tpu.fmt.magic import FileIOError


class ReferenceIndex:
    """An index file as its pages of raw rows (memory-mapped)."""

    def __init__(self, path):
        path = str(path)
        if fmt_classic.is_classic_file(path):
            with open(path, "rb") as f:
                h = fmt_classic.ClassicIndexHeader.deserialize(f)
                off = f.tell()
            self.num_hashes = h.num_hashes
            shapes = [(h.signature_size, h.row_size)]
        elif fmt_compact.is_compact_file(path):
            h, off = fmt_compact.read_compact_header(path)
            self.num_hashes = h.parameters[0].num_hashes
            shapes = [(p.signature_size, h.page_size)
                      for p in h.parameters]
        else:
            raise FileIOError(f'Could not open index path "{path}"')
        self.term_size = h.term_size
        self.canonicalize = h.canonicalize
        self.file_names = list(h.file_names)
        #: per page: uint8 [signature_size, row_bytes]
        self.pages = []
        for rows, row_bytes in shapes:
            self.pages.append(np.memmap(path, dtype=np.uint8, mode="r",
                                        offset=off,
                                        shape=(rows, row_bytes)))
            off += rows * row_bytes

    def term_hashes(self, query: bytes) -> np.ndarray:
        """uint64 [terms, h]: XXH64 of each (canonical) k-mer, seeds
        0..h-1, before the per-page modulo."""
        k = self.term_size
        q = np.frombuffer(query, dtype=np.uint8)
        if q.size < k:
            raise ValueError("query too short")
        windows = np.lib.stride_tricks.sliding_window_view(q, k)
        if self.canonicalize:
            windows, good = canonicalize_batch(windows)
            if not good.all():
                raise ValueError("Invalid DNA base pair in query string")
        return xxh64_multi_seed(np.ascontiguousarray(windows),
                                self.num_hashes)

    def scores(self, query: bytes) -> np.ndarray:
        """int64 [documents]: per-document term counts of one query."""
        hashes = self.term_hashes(query)
        counts = []
        for rows in self.pages:
            ids = (hashes % np.uint64(rows.shape[0])).astype(np.int64)
            anded = np.bitwise_and.reduce(rows[ids], axis=1)  # [T, bytes]
            bits = np.unpackbits(anded, axis=1, bitorder="little")
            counts.append(bits.sum(axis=0, dtype=np.int64))
        return np.concatenate(counts)[:len(self.file_names)]

    def search(self, query, threshold: float = 0.0,
               num_results: int = 0) -> list[tuple[str, int]]:
        """Ranked (document name, score) pairs of one query."""
        q = query.encode() if isinstance(query, str) else bytes(query)
        s = self.scores(q)
        floor = math.ceil(threshold * (len(q) - self.term_size + 1))
        docs = np.nonzero(s >= floor)[0]
        order = docs[np.lexsort((docs, -s[docs]))]
        if num_results:
            order = order[:num_results]
        return [(self.file_names[d], int(s[d])) for d in order]
