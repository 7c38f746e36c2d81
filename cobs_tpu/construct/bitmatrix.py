"""Batched Bloom bit-matrix construction.

The reference sets bits one term at a time through a scalar callback chain
(reference: cobs/construction/classic_index.cpp:39-73). Here the whole
document is processed as one batch: sliding windows -> vectorized
canonicalization -> vectorized XXH64 over all (term, seed) pairs ->
deduplicated row scatter into the byte matrix. This is both the fast host
path and the exact shape the device scatter kernel consumes.
"""

import numpy as np

from cobs_tpu import native
from cobs_tpu.core.canonical import canonicalize_batch
from cobs_tpu.core.xxh64 import xxh64_multi_seed


def doc_row_indices(windows: np.ndarray, signature_size: int,
                    num_hashes: int, canonicalize: int,
                    path: str = "") -> tuple[np.ndarray, bool]:
    """Bloom row indices for all terms of a document.

    Args:
      windows: uint8 [n, k] raw term windows.
    Returns:
      (rows uint64 [n * num_hashes], all_good) — rows are already modded by
      signature_size; all_good is False when any term contained non-ACGT
      letters (construction warns but still indexes the zero-mapped bytes,
      reference: cobs/construction/classic_index.cpp:57-66).
    """
    if canonicalize not in (0, 1):
        raise ValueError(f"unknown canonicalize value {canonicalize}")
    nat = native.window_rows(windows, num_hashes, signature_size,
                             canonicalize)
    if nat is not None:
        return nat
    all_good = True
    if canonicalize == 1:
        windows, good = canonicalize_batch(windows)
        all_good = bool(good.all())
    hashes = xxh64_multi_seed(windows, num_hashes)
    rows = (hashes % np.uint64(signature_size)).ravel()
    return rows, all_good


def set_bits(data: np.ndarray, rows: np.ndarray, doc_index: int) -> None:
    """OR document `doc_index`'s bit into the given matrix rows.

    data: uint8 [signature_size, row_size]; LSB-first bit layout
    (reference: cobs/construction/classic_index.cpp:40-43).
    """
    if rows.size == 0:
        return
    if native.set_bits(data, rows, doc_index):
        return
    unique_rows = np.unique(rows)
    data[unique_rows, doc_index >> 3] |= np.uint8(1 << (doc_index & 7))


def build_batch_matrix(entries, signature_size: int, row_size: int,
                       term_size: int, num_hashes: int, canonicalize: int,
                       warn, num_threads: int = 0) -> np.ndarray:
    """Construct the bit matrix for one batch of documents.

    Parallelizes over groups of 8 documents — one byte column each, so
    worker threads never write the same byte (the reference's
    false-sharing-free scheme, reference:
    cobs/construction/classic_index.cpp:96-118). The native hashing
    kernels release the GIL, so Python threads give real parallelism.

    Returns uint8 [signature_size, row_size].
    """
    import concurrent.futures

    from cobs_tpu.settings import settings

    data = np.zeros((signature_size, row_size), dtype=np.uint8)

    def do_octet(start: int) -> list[str]:
        warned = []
        for doc_index in range(start, min(start + 8, len(entries))):
            entry = entries[doc_index]
            shown_warning = False
            for windows in entry.term_windows(term_size):
                rows, good = doc_row_indices(
                    windows, signature_size, num_hashes, canonicalize)
                if not good and not shown_warning:
                    warned.append(str(entry.path))
                    shown_warning = True
                set_bits(data, rows, doc_index)
        return warned

    octets = range(0, len(entries), 8)
    workers = num_threads or settings.threads or 1
    if workers > 1 and len(entries) > 8:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            warned_lists = list(pool.map(do_octet, octets))
    else:
        warned_lists = [do_octet(o) for o in octets]
    for warned in warned_lists:
        for path in warned:
            warn(f"WARNING: Invalid DNA base pair (not ACGT) "
                 f"in document: {path}")
    return data
