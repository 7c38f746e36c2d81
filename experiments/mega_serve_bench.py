"""Mega-dispatch serving sweep on the GPU.

Measures the production serving loop (Search.search_stream — hashing
overlap + bounded in-flight window + multi-batch mega-dispatch) at
interleaved (batch_size, mega_batches) configs in ONE process, taking
the per-config best across rounds, so that configs are compared on one
device in one process.

  python experiments/mega_serve_bench.py /root/bench_data/rand10k.cobs_classic \
      --queries 32768 --rounds 3

K batches per device program divide the fixed per-dispatch+fetch cost
by K; whether that pays on the H100 is not yet measured (PERF.md).
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def random_queries(n, num_kmers, term_size=31, seed=0xC0B5):
    rng = np.random.default_rng(seed)
    length = num_kmers + term_size - 1
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [bytes(alphabet[c]) for c in codes]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("index")
    ap.add_argument("--num-kmers", type=int, default=1000)
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--threshold", type=float, default=0.8)
    ap.add_argument("--limit", type=int, default=100,
                    help="top-k per query (the reference default "
                         "query mode is -t 0.8 -l 100)")
    ap.add_argument("--configs",
                    default="2048:1,2048:8,2048:16,1024:16,1024:1",
                    help="comma list of "
                         "B:mega[:tier[:ahead[:groups[:prepack]]]] "
                         "(tier 1 = threshold-compacted top-k fetch, "
                         "the default; 0 = full [B, k] fetch; ahead = "
                         "hash-ahead batches, default 4; groups = "
                         "dispatched-ahead mega groups, default 2; "
                         "prepack 1 = worker-side query pack, the "
                         "default) — put variants in one list for a "
                         "drift-proof interleaved A/B")
    args = ap.parse_args()

    from cobs_tpu.query.search import Search
    from cobs_tpu.settings import settings

    configs = []
    for c in args.configs.split(","):
        parts = [int(x) for x in c.split(":")]
        parts += [1, 4, 2, 1][len(parts) - 2:]
        configs.append(tuple(parts[:6]))
    queries = random_queries(args.queries, args.num_kmers)
    print(f"index={args.index} queries={len(queries)} "
          f"T={args.num_kmers} limit={args.limit}", flush=True)
    s = Search(args.index)

    def rep(B, mega, tier, ahead, groups, prepack, qs):
        import os
        settings.mega_batches = mega
        settings.tier_fetch = bool(tier)
        settings.hash_ahead = ahead
        settings.dispatch_groups = groups
        os.environ["COBS_TPU_PREPACK"] = "1" if prepack else "0"
        t0 = time.perf_counter()
        n = 0
        for _res in s.search_stream(qs, args.threshold, args.limit,
                                    batch_size=B):
            n += 1
        dt = time.perf_counter() - t0
        return n / dt, dt

    # warmup: compile every (B, K-ladder) variant outside the clock
    for cfg in configs:
        qps, dt = rep(*cfg, queries[:cfg[0] * max(1, cfg[1])])
        print(f"warmup {cfg}: {qps:.0f} q/s ({dt:.1f}s)", flush=True)

    best = {}
    for rnd in range(1, args.rounds + 1):
        for cfg in configs:
            qps, dt = rep(*cfg, queries)
            best[cfg] = max(best.get(cfg, 0.0), qps)
            print(f"round {rnd} {cfg}: {qps:.0f} q/s ({dt:.1f}s)",
                  flush=True)

    from cobs_tpu.query.engine import _tier_counters
    print(f"tier counters: {_tier_counters}", flush=True)
    for (B, mega, tier, ahead, groups, prepack), qps in sorted(
            best.items()):
        print(f"RESULT name=mega_serve B={B} mega={mega} tier={tier} "
              f"ahead={ahead} groups={groups} prepack={prepack} "
              f"threshold={args.threshold} limit={args.limit} "
              f"queries_per_s={qps:.1f}")


if __name__ == "__main__":
    main()
