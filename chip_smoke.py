"""Smoke test of the main path on the GPU: build, query and serve.

    python chip_smoke.py             # one card
    python chip_smoke.py --cards 4   # the document-sharded mesh, four cards

One card, phase by phase (each prints one line of what it checked; any
failure raises and exits non-zero):

  device  refuse anything but a GPU; card name and power limit, versions
  golden  classic/compact construct + query of tests/data/fasta via the CLI
  scale   the reference's classic-construct-random deployment (2 Mi-bit
          signature, 10,000 documents, h=1) resident on the card; top-k and
          full-rank queries of 1,000 k-mers through search_stream, compared
          with the host-scored StreamedIndex and the NumPy reference
  hash    device query hashing bit-exact with the host hashing
  serve   QueryServer in this process, several concurrent clients
  report  memory analysis, peak memory, one plain-XLA gather+count timing

With --cards 4 only the mesh path runs: the same index sharded by document
over four cards, compared with the host-scored StreamedIndex, plus the
federation and sequence-split checks of __graft_entry__.

Scores are int32 counts built from uint32 bit operations: no matmul and no
float anywhere, so TF32 does not apply and every comparison is exact
(tolerance 0).

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

import jax

import cobs_tpu
from cobs_tpu.cli import main as cli
from cobs_tpu.query import engine
from cobs_tpu.query.reference import ReferenceIndex
from cobs_tpu.query.search import Search

ROOT = Path(__file__).resolve().parent
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
#: reference parity anchor (`cobs query -t 0` on tests/data/fasta)
GOLDEN_CLASSIC = [("sample1", 20), ("sample7", 3), ("sample2", 1),
                  ("sample4", 1), ("sample6", 1), ("sample3", 0),
                  ("sample5", 0)]
GOLDEN_COMPACT = [("sample1", 20)]

#: classic-construct-random defaults (reference: src/cobs.cpp:243-291)
SIGNATURE_SIZE = 2 * 1024 * 1024
NUM_DOCUMENTS = 10_000
DOCUMENT_SIZE = 1_000_000
NUM_HASHES = 1
TERM_SIZE = 31
#: benchmark-fpr query length in k-mers (BASELINE.md)
QUERY_TERMS = 1000
TOP_K = 100
BATCH = 64
#: queries compared: top-k (all), full rank, and against the NumPy reference
N_QUERIES, N_FULL_RANK, N_NUMPY = 1024, 64, 8

#: published HBM bandwidth of the H100 SXM (NVIDIA H100 data sheet)
H100_HBM_BYTES_PER_S = 3.35e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what="check failed") -> None:
    """An assertion that `python -O` cannot strip."""
    if not ok:
        raise AssertionError(what)


def card_info() -> str:
    """`name, power.limit` of every card, read by nvidia-smi (a child
    process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpus(count: int) -> list:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found "
                         f"{len(devs)}")
    return devs[:count]


def pairs(results) -> list:
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


def random_queries(seed: int, n: int) -> list:
    """n random ACGT queries of QUERY_TERMS k-mers each."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = QUERY_TERMS + TERM_SIZE - 1
    rows = acgt[rng.integers(0, 4, size=(n, L))]
    return [r.tobytes().decode() for r in rows]


def thresholds(doc_kmers: int) -> tuple[float, float]:
    """(top-k, full-rank) thresholds for random queries on a random
    index: a random term hits a document with the row density
    p = 1 - (1 - 1/sig)^doc_kmers, so a score is ~Binomial(terms, p).
    Top-k sits four deviations below the mean (every query fills its
    k results, ties included); full rank at the mean (about half the
    documents, a long ranked list)."""
    p = -math.expm1(doc_kmers * math.log1p(-1.0 / SIGNATURE_SIZE))
    mean = QUERY_TERMS * p
    sd = math.sqrt(QUERY_TERMS * p * (1 - p))
    return max(0.0, mean - 4 * sd) / QUERY_TERMS, mean / QUERY_TERMS


# ------------------------------------------------------------- phases

def phase_device(count: int) -> list:
    devs = require_gpus(count)
    say("device", f"nvidia-smi: {card_info()}")
    say("device", f"jax {jax.__version__}, {len(jax.devices())} x "
        f"{devs[0].device_kind} ({devs[0].platform}), compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    return devs


def cli_lines(argv: list) -> list:
    """Run the `cobs` CLI in-process; its tab-separated result lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cobs {argv[0]} exited {rc}")
    return [tuple(line.split("\t")) for line in buf.getvalue().splitlines()
            if "\t" in line]


def phase_golden(work: Path) -> None:
    fasta = work / "fasta"
    shutil.copytree(ROOT / "tests" / "data" / "fasta", fasta,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    classic = work / "golden.cobs_classic"
    compact = work / "golden.cobs_compact"
    cli_lines(["classic-construct", str(fasta), str(classic)])
    cli_lines(["compact-construct", str(fasta), str(compact)])
    got = [(n, int(s)) for n, s in cli_lines(
        ["query", "-i", str(classic), "-t", "0", GOLDEN_QUERY])]
    check(got == GOLDEN_CLASSIC, f"classic golden: {got}")
    got_c = [(n, int(s)) for n, s in cli_lines(
        ["query", "-i", str(compact), GOLDEN_QUERY])]
    check(got_c == GOLDEN_COMPACT, f"compact golden: {got_c}")
    say("golden", f"classic -t 0: {len(got)} lines equal the anchor "
        f"{got[0]}..{got[-1]}; compact -t 0.8: {got_c}")


def build_scale_index(path: Path, seed: int, doc_kmers: int) -> float:
    t0 = time.perf_counter()
    cobs_tpu.classic_construct_random(
        str(path), signature_size=SIGNATURE_SIZE,
        num_documents=NUM_DOCUMENTS, document_size=doc_kmers,
        num_hashes=NUM_HASHES, seed=seed)
    return time.perf_counter() - t0


def reduced(doc_kmers: int) -> str:
    """The cut of the reference deployment, if any (only the bit
    density changes; the index's shape and bytes do not)."""
    if doc_kmers == DOCUMENT_SIZE:
        return "none"
    return f"document_size {doc_kmers} of {DOCUMENT_SIZE} k-mers"


def host_reference(path: Path) -> Search:
    """The host-scored streamed backend (native cobs_score_batch)."""
    host = Search(str(path), streamed=True)
    ix = host.index_files[0]
    check(isinstance(ix, engine.StreamedIndex) and ix._host_score(),
          "reference backend is not host-scored")
    return host


def compare_scale(phase: str, s: Search, host: Search, ref, queries,
                  n_full: int, n_numpy: int, t_topk: float,
                  t_full: float) -> None:
    """search_stream top-k over every query and full rank over the
    first n_full, each equal to the host-scored backend; the first
    n_numpy of both also equal to the NumPy reference."""
    t0 = time.perf_counter()
    topk = pairs(s.search_stream(queries, t_topk, TOP_K, BATCH))
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = pairs(s.search_stream(queries, t_topk, TOP_K, BATCH))
    t_warm = time.perf_counter() - t0
    check(again == topk, "a repeated top-k pass differs")
    full = pairs(s.search_stream(queries[:n_full], t_full, 0, BATCH))
    check(all(len(r) == TOP_K for r in topk),
          "a top-k query did not fill its k results")
    check(all(len(r) > 0 for r in full), "a full-rank query had no hits")
    want_topk = pairs(host.search_stream(queries, t_topk, TOP_K, BATCH))
    want_full = pairs(host.search_stream(queries[:n_full], t_full, 0,
                                         BATCH))
    check(topk == want_topk, "top-k differs from the host-scored index")
    check(full == want_full, "full rank differs from the host-scored index")
    for q, a, b in zip(queries[:n_numpy], topk, full):
        check(a == ref.search(q, t_topk, TOP_K), "top-k != NumPy ref")
        check(b == ref.search(q, t_full, 0), "full rank != NumPy ref")
    mean_full = np.mean([len(r) for r in full])
    say(phase, f"{len(queries)} top-k (t={t_topk:.4f}, k={TOP_K}) and "
        f"{n_full} full-rank (t={t_full:.4f}, mean {mean_full:.0f} "
        f"results) queries of {QUERY_TERMS} k-mers equal the host-scored "
        f"StreamedIndex exactly; first {n_numpy} equal the NumPy reference"
        f"; top-k pass {t_cold:.2f} s cold (compiles included), "
        f"{t_warm:.2f} s warm")


def phase_scale(path: Path, seed: int, doc_kmers: int, n_queries: int,
                n_full: int, n_numpy: int):
    t_build = build_scale_index(path, seed, doc_kmers)
    say("scale", f"built {NUM_DOCUMENTS} docs x {SIGNATURE_SIZE} rows, "
        f"h={NUM_HASHES}, {path.stat().st_size} B on disk in "
        f"{t_build:.1f} s; reduced: {reduced(doc_kmers)}")
    t0 = time.perf_counter()
    s = Search(str(path))
    ix = s.index_files[0]
    check(isinstance(ix, engine.DeviceIndex),
          f"Search picked {type(ix).__name__}, not DeviceIndex")
    jax.block_until_ready(ix.matrix)
    say("scale", f"Search chose DeviceIndex: matrix {ix.matrix.shape} "
        f"{ix.matrix.dtype} = {ix.matrix.nbytes} B on "
        f"{sorted(ix.matrix.devices(), key=str)} (load "
        f"{time.perf_counter() - t0:.1f} s)")
    queries = random_queries(seed + 1, n_queries)
    t_topk, t_full = thresholds(doc_kmers)
    compare_scale("scale", s, host_reference(path), ReferenceIndex(path),
                  queries, n_full, n_numpy, t_topk, t_full)
    return s, queries, (t_topk, t_full)


def phase_hash(queries: list) -> None:
    """ops/device_hash.rows_from_queries on the card, raw and 2-bit
    packed input, against the host native hashing."""
    from cobs_tpu.ops.device_hash import pack_queries_2bit, rows_from_queries

    qb = np.frombuffer("".join(queries).encode(), np.uint8).reshape(
        len(queries), -1)
    lens = np.full(len(queries), qb.shape[1], np.int32)
    want = np.stack([h % np.uint64(SIGNATURE_SIZE) for h in
                     engine.create_hashes([q.encode() for q in queries],
                                          TERM_SIZE, NUM_HASHES, 1)])
    fn = jax.jit(rows_from_queries, static_argnums=tuple(range(2, 9)))
    static = (TERM_SIZE, NUM_HASHES, 1, (SIGNATURE_SIZE,), (0,),
              SIGNATURE_SIZE)
    with jax.enable_x64():
        raw = fn(qb, lens, *static, 0)
        packed = fn(pack_queries_2bit(qb), lens, *static, qb.shape[1])
        check(raw.devices() == {jax.devices()[0]})
        raw, packed = np.asarray(raw), np.asarray(packed)
    check(raw.shape == (len(queries), QUERY_TERMS, NUM_HASHES, 1))
    check((raw[..., 0] == want).all(), "device hash (raw) != host")
    check((packed[..., 0] == want).all(), "device hash (2-bit) != host")
    say("hash", f"rows_from_queries on {raw.size} terms of "
        f"{len(queries)} queries (raw and 2-bit packed) equal the host "
        f"native XXH64 % {SIGNATURE_SIZE} bit for bit")


def phase_serve(s: Search, queries: list, work: Path, t_low: float,
                n_clients: int = 3, per_client: int = 32) -> None:
    """QueryServer (-t 0.8 -l 100) in this process on a Unix socket;
    concurrent clients at the server's floor and below it, every
    response equal to the direct Search result."""
    from cobs_tpu.query.client import QueryClient
    from cobs_tpu.query.server import QueryServer

    # relative path: AF_UNIX paths are limited to ~100 bytes
    sock = os.path.relpath(work / "serve.sock")
    # (threshold, num_results) per client: the server defaults, and
    # below the floor (the slow path re-ranks the batch)
    plans = [(None, None), (t_low, None), (t_low, 10)]
    batches = [queries[i * per_client:(i + 1) * per_client]
               for i in range(n_clients)]
    wants = []
    for i, qs in enumerate(batches):
        t, n = plans[i % len(plans)]
        wants.append(pairs(s.search_batch(qs, 0.8 if t is None else t,
                                          TOP_K if n is None else n)))
    server = QueryServer(s, unix_path=sock, threshold=0.8,
                         num_results=TOP_K, batch_size=BATCH,
                         linger_ms=2.0)
    errors, done = [], []

    def client(i):
        try:
            t, n = plans[i % len(plans)]
            with QueryClient(sock) as c:
                got = pairs(c.search_batch(batches[i], t, n, strict=True))
            check(got == wants[i], f"client {i}: served != direct Search")
            done.append(sum(len(r) for r in got))
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    server.start()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        with QueryClient(sock) as c:
            stats = c.stats()
    finally:
        server.close()
    n = n_clients * per_client
    check(stats["queries"] >= n, stats)
    say("serve", f"{n_clients} clients x {per_client} requests "
        f"({sum(done)} results) equal direct Search; stats: "
        f"queries={stats['queries']} batches={stats.get('batches')}")


def phase_report(s: Search, queries: list, power: str) -> None:
    ix = s.index_files[0]
    qb = engine.QueryBytes([q.encode() for q in queries[:BATCH]])
    dq, dl, _, sigs, offs, plen = engine._device_hash_args(ix, qb)
    mask = engine._topk_mask(ix)
    cache = jax.config.jax_enable_compilation_cache
    jax.clear_caches()  # the serve phase compiled this program already
    with jax.enable_x64():
        lowered = engine._hash_gather_count_topk.lower(
            ix.matrix, dq, dl, mask, ix.term_size, ix.num_hashes,
            ix.canonicalize, sigs, offs, ix.zero_row, TOP_K, plen)
        # a cold XLA compile: bypass the persistent cache for this one
        jax.config.update("jax_enable_compilation_cache", False)
        try:
            t0 = time.perf_counter()
            compiled = lowered.compile()
            t_compile = time.perf_counter() - t0
        finally:
            jax.config.update("jax_enable_compilation_cache", cache)
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    say("report", f"top-k program (B={BATCH}, k={TOP_K}) cold compile "
        f"{t_compile:.2f} s; memory_analysis: " + ", ".join(
            f"{f}={getattr(ma, f, None)}" for f in fields))

    # the plain XLA gather+count at B=64, T=1,024 on the scale matrix
    T = 1024
    rng = np.random.default_rng(0)
    rows = jax.device_put(rng.integers(
        0, SIGNATURE_SIZE, size=(BATCH, T, NUM_HASHES, 1)).astype(np.int32))
    t0 = time.perf_counter()
    jax.block_until_ready(engine._gather_and_count(ix.matrix, rows,
                                                   NUM_HASHES))
    t_first = time.perf_counter() - t0
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(engine._gather_and_count(ix.matrix, rows,
                                                       NUM_HASHES))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    gathered = BATCH * T * NUM_HASHES * ix.matrix.shape[1] * 4
    rate = gathered / dt
    say("report", f"_gather_and_count B={BATCH} T={T} W={ix.matrix.shape[1]}"
        f": first call {t_first:.2f} s, median of 20 {dt * 1e3:.3f} ms "
        f"(min {min(times) * 1e3:.3f}) = {BATCH / dt:.0f} queries/s, "
        f"{rate / 1e9:.1f} GB/s gathered = {rate / H100_HBM_BYTES_PER_S:.3f}"
        f" of 3.35 TB/s; card {power}")
    stats = jax.devices()[0].memory_stats() or {}
    say("report", f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"bytes_limit={stats.get('bytes_limit')}")


def phase_mesh(path: Path, seed: int, doc_kmers: int, n_queries: int,
               n_full: int, n_numpy: int, devs: list) -> None:
    from __graft_entry__ import _dryrun_serving_surface
    from cobs_tpu.parallel.sharded import make_mesh

    t_build = build_scale_index(path, seed, doc_kmers)
    say("mesh", f"built the scale index in {t_build:.1f} s; reduced: "
        f"{reduced(doc_kmers)}")
    mesh = make_mesh(n_batch=1, n_docs=len(devs), devices=devs)
    s = Search(str(path), mesh=mesh)
    matrix = s._sharded[0].matrix
    placed = {sh.device for sh in matrix.addressable_shards}
    check(len(matrix.sharding.device_set) == len(devs) == len(placed),
          f"matrix shards on {placed}")
    say("mesh", f"matrix {matrix.shape} sharded {matrix.sharding.spec} "
        f"over {sorted(str(d) for d in placed)}")
    t_topk, t_full = thresholds(doc_kmers)
    compare_scale("mesh", s, host_reference(path), ReferenceIndex(path),
                  random_queries(seed + 1, n_queries), n_full, n_numpy,
                  t_topk, t_full)
    _dryrun_serving_surface(mesh)
    _dryrun_serving_surface(make_mesh(n_batch=2, n_docs=len(devs) // 2,
                                      devices=devs))
    say("mesh", "2-index federation (top-k, full rank) on 1x4 and 2x2 "
        "meshes and the sequence split on 2x2 equal single-card Search")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4 = run only the document-sharded mesh path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--doc-kmers", type=int, default=DOCUMENT_SIZE,
                   help="k-mers per random document (reference default "
                        f"{DOCUMENT_SIZE}; cut to bound the build time)")
    args = p.parse_args(argv)

    devs = phase_device(args.cards)
    power = card_info().splitlines()[0]
    work = ROOT / ".chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        index = work / "scale.cobs_classic"
        if args.cards > 1:
            phase_mesh(index, args.seed, args.doc_kmers, N_QUERIES,
                       N_FULL_RANK, N_NUMPY, devs)
        else:
            phase_golden(work)
            s, queries, (t_topk, _) = phase_scale(
                index, args.seed, args.doc_kmers, N_QUERIES, N_FULL_RANK,
                N_NUMPY)
            phase_hash(queries)
            phase_serve(s, queries, work, t_topk)
            phase_report(s, queries, power)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
