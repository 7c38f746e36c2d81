"""Driver benchmark: query throughput of the bit-sliced signature index.

Mirrors the reference's `cobs benchmark-fpr` harness semantics
(reference: src/cobs.cpp:605-730 — random index, warmup, measured query
loop) at the reference's synthetic scale (`classic-construct-random`
defaults: 10,000 documents, 2 Mi-bit signature, 1000-k-mer queries,
reference: src/cobs.cpp:243-291).

Prints ONE JSON line:
  {"metric": "query_throughput", "value": <queries/s>, "unit":
   "queries/s", "vs_baseline": <ratio over the reference's single-node
   memory-bandwidth roofline>}

The reference publishes no numeric baselines (see BASELINE.md), so
`vs_baseline` compares against the reference's *best-case* single-node
throughput at this workload: its mmap row gather + SSE2 scoring is
DRAM-bound, reading T*h rows of row_size bytes per query; at an
(optimistic) 50 GB/s of effective random-row DRAM bandwidth that is
  50e9 / (1000 * 1 * 1250) = 40,000 queries/s.
Timing protocol: several query batches are scored inside ONE compiled
lax.scan dispatch and the device-to-host fetch of the (tiny,
data-dependent) per-query totals is the clock, and two scan lengths are
differenced so the per-dispatch overhead cancels.

Runs on a GPU listed in the peak table below and nowhere else: an
unknown device (the CPU included) is an error, never a fallback.
"""

import json
import sys
import time

#: published peak device-memory bandwidth, bytes/s, by
#: jax.Device.device_kind (NVIDIA H100 data sheet: H100 SXM5 80 GB HBM3,
#: 3.35 TB/s)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(device_kind: str) -> float:
    """Peak memory bandwidth of a device kind; unknown kinds raise."""
    try:
        return PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no bandwidth peak for device kind {device_kind!r}; add it "
            "to bench.PEAK_BYTES_PER_S with its source") from None


def main() -> None:
    import numpy as np

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    roofline = peak_bytes_per_s(dev.device_kind)

    sig_size = 1 << 21      # 2 Mi Bloom rows (reference default)
    num_docs = 10_000
    B, T, iters = 64, 1000, 36
    num_hashes = 1
    W = max(128, -(-(-(-num_docs // 8) // 4) // 128) * 128)

    print(f"bench: {dev.device_kind} sig={sig_size} docs={num_docs} "
          f"W={W} B={B} T={T}", file=sys.stderr)

    rng = np.random.default_rng(0xC0B5)
    # random index generated on device (no multi-GB host transfer)
    key = jax.random.key(0xC0B5)
    matrix = jax.jit(
        lambda k: jax.random.bits(
            k, (sig_size + 1, W), dtype=jnp.uint32).at[-1].set(0)
    )(key)
    jax.block_until_ready(matrix)

    from cobs_tpu.query.engine import _gather_and_count

    from jax import lax

    @jax.jit
    def multi(m, idxs):
        """Score idxs [K, B, T, h, P] sequentially on device; returns
        per-query totals [K, B] (tiny, but data-dependent on every
        gathered row, so fetching it forces the whole chain)."""
        def body(carry, idx):
            return carry, _gather_and_count(m, idx, num_hashes) \
                .sum(axis=1)
        _, totals = lax.scan(body, 0, idxs)
        return totals

    # queries enter the engine padded to the term bucket with zero-row
    # terms, exactly as serving does (engine._bucket); q/s still counts
    # real (T-term) queries.
    from cobs_tpu.query.engine import _bucket
    T_pad = _bucket(T)

    def make_idxs(K):
        idx = np.full((K, B, T_pad, num_hashes, 1), sig_size,
                      dtype=np.int32)  # sig_size = the all-zero row
        idx[:, :, :T] = rng.integers(
            0, sig_size, size=(K, B, T, num_hashes, 1)).astype(np.int32)
        return jnp.asarray(idx)

    # difference two scan lengths: per-dispatch overhead cancels,
    # leaving device time. Small/large measurements interleave and take
    # per-size minima so transient slowdowns cannot skew the difference.
    k_small, k_large = 4, iters
    idxs_s, idxs_l = make_idxs(k_small), make_idxs(k_large)
    np.asarray(multi(matrix, idxs_s))    # compile + warm
    np.asarray(multi(matrix, idxs_l))
    best_s = best_l = float("inf")
    for _ in range(10):
        t0 = time.perf_counter()
        np.asarray(multi(matrix, idxs_s))  # fetch = true sync
        best_s = min(best_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(multi(matrix, idxs_l))
        best_l = min(best_l, time.perf_counter() - t0)
    dt = max(best_l - best_s, 1e-9)
    iters = k_large - k_small

    queries = iters * B
    qps = queries / dt
    # hot-loop HBM traffic: the row gather reads T_pad*h rows of W
    # words per query (padding terms gather the zero row at full HBM
    # cost); score output write is negligible (B*W*32*4 per batch).
    bytes_moved = queries * T_pad * num_hashes * W * 4
    achieved = bytes_moved / dt
    # reference best case: DRAM-roofline row gather on one node
    ref_qps = 50e9 / (T * num_hashes * (num_docs / 8.0))
    vs = qps / ref_qps

    print(f"bench: {qps:.1f} queries/s ({achieved / 1e9:.1f} GB/s "
          f"gathered = {achieved / roofline:.3f} of the "
          f"{roofline / 1e12:.2f} TB/s peak); reference DRAM-roofline "
          f"~{ref_qps:.0f} q/s", file=sys.stderr)
    print(json.dumps({
        "metric": "query_throughput",
        "value": round(qps, 2),
        "unit": "queries/s",
        "vs_baseline": round(vs, 4),
    }))


if __name__ == "__main__":
    main()
