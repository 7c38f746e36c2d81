"""Capped run-coalescing A/B on a skewed heterogeneous compact index.

Builds (once) a 20k-document 4-tier corpus whose size tiers straddle
reference-default 64 B page boundaries AND whose run profile is skewed
(one dominant tier + short tails), so the uncapped run merge pads every
merged page to the dominant run's width. Loads the SAME index file
three ways in one process — capped (auto cost model), uncapped
(COBS_TPU_RUN_CAP=0), and uncoalesced (COBS_TPU_COALESCE_PAGES=0) —
and interleaves serving reps round-robin, so the three layouts are
compared on one device in one process.

  python experiments/runcap_serve_bench.py /tmp/runcap --queries 32768
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_corpus(root: Path):
    docs = root / "docs"
    if (root / "skew.cobs_compact").exists():
        return root / "skew.cobs_compact"
    docs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0xCAFE)
    bases = np.frombuffer(b"ACGT", np.uint8)
    # 14848 small docs (29 pages), then three short tiers (~3-4 pages
    # each): sorted-by-size construction yields runs ~[29, 4, 4, 3]
    tiers = [(14848, 150), (2048, 600), (2048, 1800), (1536, 5000)]
    i = 0
    for n, L in tiers:
        for _ in range(n):
            seq = bases[rng.integers(0, 4, size=L)].tobytes()
            (docs / f"d{i:05d}.fasta").write_bytes(b">s\n" + seq
                                                   + b"\n")
            i += 1
    import cobs_tpu

    out = root / "skew.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(docs), out,
        index_params=cobs_tpu.CompactIndexParameters(
            num_hashes=1, clobber=True))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--num-kmers", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args()

    idx = build_corpus(Path(args.workdir))
    print(f"index={idx} ({idx.stat().st_size >> 20} MiB)", flush=True)

    from cobs_tpu.query.search import Search
    from cobs_tpu.settings import settings

    settings.mega_batches = 16

    searches = {}
    for name, env in (("capped", {}), ("uncapped",
                                       {"COBS_TPU_RUN_CAP": "0"}),
                      ("plain", {"COBS_TPU_COALESCE_PAGES": "0"})):
        for k, v in env.items():
            os.environ[k] = v
        s = Search(str(idx))
        ix = s.index_files[0]
        print(f"{name}: pages={ix.num_pages} row_bytes="
              f"{ix.word_width * 4} page_docs="
              f"{None if ix.page_docs is None else list(ix.page_docs)[:6]}",
              flush=True)
        searches[name] = s
        for k in env:
            del os.environ[k]

    rng = np.random.default_rng(0xC0B5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    L = args.num_kmers + 30
    queries = [bases[c].tobytes()
               for c in rng.integers(0, 4, size=(args.queries, L),
                                     dtype=np.uint8)]

    def rep(s, qs):
        t0 = time.perf_counter()
        n = 0
        for _ in s.search_stream(qs, 0.8, 100, batch_size=args.batch):
            n += 1
        return n / (time.perf_counter() - t0)

    warm_n = args.batch * 16
    for name, s in searches.items():
        print(f"warmup {name}: {rep(s, queries[:warm_n]):.0f} q/s",
              flush=True)

    best = {}
    for rnd in range(1, args.rounds + 1):
        for name, s in searches.items():
            qps = rep(s, queries)
            best[name] = max(best.get(name, 0.0), qps)
            print(f"round {rnd} {name}: {qps:.0f} q/s", flush=True)

    for name, qps in best.items():
        print(f"RESULT name=runcap_serve variant={name} "
              f"B={args.batch} queries_per_s={qps:.1f}")


if __name__ == "__main__":
    main()
