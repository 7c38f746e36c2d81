"""Native C++ host runtime (lazy-built, ctypes-bound).

The reference's host-side hot loops are C++ (reference:
cobs/construction/classic_index.cpp:39-73); this module provides the
framework's native equivalents — batched canonicalize+XXH64+mod and
bit-matrix scatter — with a transparent NumPy fallback when no compiler
is available. ``lib()`` returns the loaded library or None.

Build artifacts land next to this file (``_native_<tag>.so``); the first
import pays one ``g++ -O3`` compile (~1s), afterwards the cached .so is
dlopen'd directly. ctypes releases the GIL during calls, so a Python
thread pool over documents achieves real host parallelism.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

_HERE = Path(__file__).parent
_SRC = _HERE / "native.cpp"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    src = _SRC.read_bytes()
    # -march=native unlocks the vectorized scoring path (AVX-512BW /
    # AVX2 bit->byte-lane expansion); safe because the .so is always
    # compiled on the machine that runs it. Falls back to plain -O3 on
    # compilers/arches that reject the flag.
    flag_sets = [["-O3", "-march=native"], ["-O3"]]
    err = None
    for flags in flag_sets:
        tag = hashlib.sha256(
            src + b"\0" + " ".join(flags).encode()).hexdigest()[:16]
        out = _HERE / f"_native_{tag}.so"
        if out.exists():
            return out
        # per-process temporary: concurrent first imports (test
        # workers, server processes) each build and rename atomically
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17",
               "-o", tmp, str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            err = e
            continue
        break
    else:
        print(f"cobs_tpu: native build failed ({err}); "
              "using NumPy fallback", file=sys.stderr)
        return None
    os.replace(tmp, out)
    # tidy stale builds
    for old in _HERE.glob("_native_*.so"):
        if old != out:
            try:
                old.unlink()
            except OSError:
                pass
    return out


def lib():
    """The loaded native library, or None when unavailable/disabled."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        if os.environ.get("COBS_TPU_NO_NATIVE"):
            _tried = True
            return None
        path = _build()
        if path is not None:
            try:
                L = ctypes.CDLL(str(path))
                i64, u64, i32 = (ctypes.c_int64, ctypes.c_uint64,
                                 ctypes.c_int32)
                p8 = ctypes.POINTER(ctypes.c_uint8)
                pu64 = ctypes.POINTER(ctypes.c_uint64)
                L.cobs_xxh64_batch.argtypes = [p8, i64, i64, u64, pu64]
                L.cobs_xxh64_batch.restype = None
                L.cobs_sequence_rows.argtypes = [
                    p8, i64, i64, i64, u64, i32, pu64]
                L.cobs_sequence_rows.restype = i32
                L.cobs_sequence_rows_mt.argtypes = [
                    p8, i64, i64, i64, u64, i32, pu64, i32]
                L.cobs_sequence_rows_mt.restype = i32
                L.cobs_window_rows.argtypes = [
                    p8, i64, i64, i64, u64, i32, pu64]
                L.cobs_window_rows.restype = i32
                L.cobs_window_rows_mt.argtypes = [
                    p8, i64, i64, i64, u64, i32, pu64, i32]
                L.cobs_window_rows_mt.restype = i32
                L.cobs_window_hashes.argtypes = [p8, i64, i64, i64, i32,
                                                 pu64]
                L.cobs_window_hashes.restype = i32
                L.cobs_random_rows.argtypes = [u64, i64, i64, i64, u64,
                                               pu64]
                L.cobs_random_rows.restype = i32
                L.cobs_set_bits.argtypes = [p8, i64, pu64, i64, i64]
                L.cobs_set_bits.restype = None
                pi64 = ctypes.POINTER(ctypes.c_int64)
                L.cobs_gather_rows.argtypes = [p8, i64, pi64, i64, p8,
                                               i64, i32]
                L.cobs_gather_rows.restype = None
                pi32 = ctypes.POINTER(ctypes.c_int32)
                L.cobs_score_batch.argtypes = [p8, i64, pi64, i64, i64,
                                               i64, i64, i64, pi32, i32]
                L.cobs_score_batch.restype = None
                L.cobs_gather_rows_file.argtypes = [
                    i32, i64, i64, pi64, i64, p8, i64, i32, i32]
                L.cobs_gather_rows_file.restype = i32
                L.cobs_format_results.argtypes = [
                    p8, pi64, ctypes.c_void_p, ctypes.c_void_p, i64,
                    p8, i64]
                L.cobs_format_results.restype = i64
                _lib = L
            except OSError as e:
                print(f"cobs_tpu: native load failed ({e}); "
                      "using NumPy fallback", file=sys.stderr)
        _tried = True
        return _lib


def _ptr8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def window_rows(windows, num_hashes: int, sig_size: int,
                canonical: int):
    """Native canonicalize+hash+mod over windows u8 [n, k].

    Returns (rows u64 [n*num_hashes], all_good) or None if the native
    library is unavailable. Sliding-window *views* (strides (1, 1), as
    produced by ingest.util.sliding_windows) take a zero-copy path that
    hands the underlying sequence bytes to C++ directly instead of
    materializing the n*k window matrix.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    from cobs_tpu.settings import settings

    windows = np.asarray(windows, dtype=np.uint8)
    n, k = windows.shape
    out = np.empty(n * num_hashes, dtype=np.uint64)
    threads = max(1, settings.threads)
    if windows.strides == (1, 1) and n > 0:
        good = L.cobs_sequence_rows_mt(_ptr8(windows), n + k - 1, k,
                                       num_hashes, sig_size, canonical,
                                       _ptr64(out), threads)
        return out, bool(good)
    windows = np.ascontiguousarray(windows)
    good = L.cobs_window_rows_mt(_ptr8(windows), n, k, num_hashes,
                                 sig_size, canonical, _ptr64(out),
                                 threads)
    return out, bool(good)


def random_rows(seed: int, n: int, k: int, num_hashes: int,
                sig_size: int):
    """Fused random-document rows for classic_construct_random:
    generate n random k-mers (splitmix64 stream from `seed`),
    canonicalize, hash, mod — entirely in C++. Returns u64
    [n*num_hashes] or None when unavailable (or k > 32, which the
    one-draw-per-term PRNG scheme cannot cover)."""
    import numpy as np

    L = lib()
    if L is None or not (1 <= k <= 32):
        return None
    out = np.empty(n * num_hashes, dtype=np.uint64)
    if not L.cobs_random_rows(seed & (2**64 - 1), n, k, num_hashes,
                              sig_size, _ptr64(out)):
        return None
    return out


def window_hashes(windows, num_hashes: int, canonical: int):
    """Native canonicalize+hash (un-modded) -> u64 [n, num_hashes]."""
    import numpy as np

    L = lib()
    if L is None:
        return None
    windows = np.ascontiguousarray(windows, dtype=np.uint8)
    n, k = windows.shape
    out = np.empty((n, num_hashes), dtype=np.uint64)
    good = L.cobs_window_hashes(_ptr8(windows), n, k, num_hashes,
                                canonical, _ptr64(out))
    return out, bool(good)


def set_bits(data, rows, doc_index: int):
    """Native bit scatter; returns False if unavailable."""
    import numpy as np

    L = lib()
    if L is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    assert data.flags.c_contiguous and data.dtype == np.uint8
    L.cobs_set_bits(_ptr8(data), data.shape[1], _ptr64(rows),
                    rows.size, doc_index)
    return True


def score_batch_host(base, row_bytes: int, rows, zero_id: int,
                     num_threads: int):
    """Host-side batched scoring over a contiguous mmap'd payload.

    base: uint8 [total_rows, row_bytes] (typically an np.memmap);
    rows: int64 [B, T, h, P] global row ids (zero_id = padding term).
    Returns int32 [B, P * 8 * row_bytes] scores, or None when the
    native library is unavailable.
    """
    import numpy as np

    L = lib()
    if L is None or not hasattr(L, "cobs_score_batch"):
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    B, T, h, P = rows.shape
    out = np.empty((B, P * 8 * row_bytes), dtype=np.int32)
    L.cobs_score_batch(
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        row_bytes,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, T, h, P, zero_id,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_threads)
    return out


#: io_uring availability memo: None = unknown, False = setup failed
#: once (seccomp / old kernel) — skip the syscall on later batches
_uring_ok: bool | None = None

#: RWF_DONTCACHE support memo: None = unprobed, False = the kernel or
#: filesystem rejected the flag (reads completed through the cache)
_dontcache_ok: bool | None = None


def dontcache_supported() -> bool | None:
    """Whether RWF_DONTCACHE reads worked on the last gather that
    requested them (None before any such gather ran)."""
    return _dontcache_ok


def gather_rows_file(path: str, base_off: int, row_bytes: int, rows,
                     out, depth: int = 256,
                     dontcache: bool = False) -> bool:
    """Batched async file reads: out[i] = file[base_off + rows[i]*rb].

    The analog of the reference's O_DIRECT AIO batch (reference:
    cobs/query/compact_index/aio_search_file.cpp:23-97): a deep
    io_uring queue keeps the disk busy with hundreds of scattered row
    reads instead of one synchronous page fault at a time per thread.
    dontcache=True additionally asks the kernel to drop each read's
    pages once the IO completes (RWF_DONTCACHE — the buffered analog
    of the reference's O_DIRECT open, aio_search_file.cpp:23-41), so a
    cold-cache measurement loop never warms the cache it is measured
    against; support is reported via :func:`dontcache_supported` and
    the reads complete normally (through the cache) where the flag is
    unavailable. Returns False when io_uring (or the native library)
    is unavailable — callers fall back to the threaded mmap gather.
    """
    import numpy as np

    global _uring_ok, _dontcache_ok
    L = lib()
    if L is None or _uring_ok is False:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    assert out.flags.c_contiguous and out.dtype == np.uint8
    fd = os.open(path, os.O_RDONLY)
    try:
        # disable kernel readahead: row reads are ~1 KB scattered over
        # a multi-GB file, and each buffered miss otherwise triggers up
        # to read_ahead_kb (8 MB on stock images) of speculative IO —
        # measured on a 2.5 GB index: 3-30k IOPS erratic with readahead
        # vs a steady 120-176k with FADV_RANDOM
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_RANDOM)
        except (AttributeError, OSError):
            pass
        rc = L.cobs_gather_rows_file(
            fd, base_off, row_bytes,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rows.size, _ptr8(out), out.shape[1], depth,
            1 if dontcache else 0)
    finally:
        os.close(fd)
    if rc == -1:
        _uring_ok = False
        return False
    if rc not in (0, 1):
        raise OSError(f"cobs_gather_rows_file IO error (rc={rc}) "
                      f"reading {path}")
    _uring_ok = True
    if dontcache:
        _dontcache_ok = rc == 0
    return True


def gather_rows(base, row_bytes: int, rows, out, num_threads: int):
    """Parallel scattered row copy: out[i] = base[rows[i]].

    base: uint8 [num_rows, row_bytes] (typically an np.memmap);
    rows: int64 [n]; out: uint8 [n, out_stride] C-contiguous with
    out_stride >= row_bytes. Returns False when native is unavailable.
    """
    import numpy as np

    L = lib()
    if L is None or not hasattr(L, "cobs_gather_rows"):
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    assert out.flags.c_contiguous and out.dtype == np.uint8
    L.cobs_gather_rows(
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        row_bytes,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rows.size,
        _ptr8(out), out.shape[1], num_threads)
    return True


class ResultFormatter:
    """GIL-free JSON serializer for ranked result lists (the serving
    hot path: json.dumps measured 37-40 us per k=100 response and
    bounded the server at ~25k responses/s/core; the native formatter
    runs ~1-2 us). Holds the index's document names PRE-JSON-QUOTED in
    one blob — construct once per index set; calls are thread-safe
    (the server renders responses on per-connection writer threads so
    serialization overlaps the scorer's device waits).

    __call__(gidx, scores) -> the JSON fragment [["name",score],...]
    as bytes, or None when the native runtime is unavailable (caller
    falls back to json.dumps).
    """

    def __init__(self, names):
        import json

        import numpy as np

        quoted = [json.dumps(n).encode() for n in names]
        self._blob = b"".join(quoted)
        offs = np.zeros(len(quoted) + 1, dtype=np.int64)
        np.cumsum([len(q) for q in quoted], out=offs[1:])
        self._offs = np.ascontiguousarray(offs)
        self._max_name = max((len(q) for q in quoted), default=0)
        self._np = np
        self._L = lib()
        if self._L is not None:
            pi64 = ctypes.POINTER(ctypes.c_int64)
            self._pblob = ctypes.cast(ctypes.c_char_p(self._blob),
                                      ctypes.POINTER(ctypes.c_uint8))
            self._poffs = self._offs.ctypes.data_as(pi64)
            self._pi64 = pi64

    def __call__(self, gidx, scores) -> bytes | None:
        L = self._L
        if L is None:
            return None
        np = self._np
        gidx = np.ascontiguousarray(gidx, dtype=np.int64)
        scores = np.ascontiguousarray(scores, dtype=np.int64)
        n = gidx.size
        cap = 2 + n * (26 + self._max_name)
        buf = np.empty(cap, dtype=np.uint8)  # per call: thread-safe
        w = L.cobs_format_results(
            self._pblob, self._poffs, gidx.ctypes.data,
            scores.ctypes.data, n, _ptr8(buf), cap)
        if w < 0:
            return None
        return buf[:w].tobytes()
