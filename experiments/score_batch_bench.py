"""Microbenchmark for the native host scoring kernel.

`cobs_score_batch` dominates the streamed (host-scored) serving path.
This harness times the kernel alone on synthetic data so changes to
its accumulation can be compared like-for-like.

Run: python experiments/score_batch_bench.py [B T docs h]
"""

import sys
import time

import numpy as np

from cobs_tpu.native import lib, _ptr8

import ctypes


def bench(B=64, T=1000, docs=10_000, h=1, density=0.3, iters=5,
          sig_log2=18, file_backed=0):
    L = lib()
    assert L is not None, "native library unavailable"
    rng = np.random.default_rng(7)
    row_bytes = (docs + 7) // 8
    # 2^18 rows x row_bytes comfortably exceeds L3, so gathers hit
    # DRAM; sig_log2=21 reproduces the full 2.6 GB serving index
    # (TLB/page-walk costs included) at the price of slower setup
    sig = 1 << sig_log2
    shape = (sig + 1, row_bytes)
    # per-bit density ~0.5^n via AND of n random byte planes; pick n so
    # the AND of h gathered rows lands near the requested density
    per_row = density ** (1.0 / max(h, 1))
    n = max(1, round(np.log(per_row) / np.log(0.5)))
    payload = rng.integers(0, 256, size=shape, dtype=np.uint8)
    for _ in range(n - 1):
        payload &= rng.integers(0, 256, size=shape, dtype=np.uint8)
    payload[sig] = 0  # zero row
    zero_id = sig
    if file_backed:
        # serving reality check: StreamedIndex scores through a
        # file-backed mmap (4 KiB pages, no THP) — anonymous test
        # buffers get transparent hugepages and understate TLB cost
        import mmap
        import tempfile

        tf = tempfile.NamedTemporaryFile(dir="/tmp", delete=False)
        payload.tofile(tf)
        tf.flush()
        mm = mmap.mmap(tf.fileno(), 0, prot=mmap.PROT_READ)
        warmed = np.frombuffer(mm, dtype=np.uint8).reshape(payload.shape)
        # touch one byte per 4 KiB page: fully warm page cache
        int(warmed.reshape(-1)[::4096].astype(np.int64).sum())
        payload = warmed
    rows = rng.integers(0, sig, size=(B, T, h, 1)).astype(np.int64)
    out = np.zeros((B, 8 * row_bytes), dtype=np.int32)

    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        L.cobs_score_batch(
            _ptr8(payload), row_bytes,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            B, T, h, 1, zero_id,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 4)
        best = min(best, time.perf_counter() - t0)
    gb = B * T * h * row_bytes / 1e9
    print(f"B={B} T={T} docs={docs} h={h}: {best*1e3:.1f} ms/batch "
          f"({B/best:.0f} q/s kernel-only, {gb/best:.2f} GB/s rows)")
    return best


if __name__ == "__main__":
    args = [float(a) if "." in a else int(a) for a in sys.argv[1:]]
    bench(*args)
