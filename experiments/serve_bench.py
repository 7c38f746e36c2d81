"""Serving front-end overhead: QueryServer through a real socket vs
the direct pipelined stream on the same index and backend.

The server adds socket transport, JSON framing, linger batching and
per-request refinement on top of `search_stream`'s scoring path; this
harness measures what that costs at serving batch sizes:

  python experiments/serve_bench.py /tmp/benchidx/rand.cobs_classic \
      --limit 100 --batch 1024 --clients 4 --queries 8192

Prints RESULT lines:
  RESULT mode=direct ... queries_per_s=...
  RESULT mode=served ... queries_per_s=... overhead_pct=...

Run on the GPU for device backends (no JAX_PLATFORMS override);
`--streamed` exercises the host-scored backend and needs no device.
Client processes are spawned and never import JAX, so the server
process is the only one on the card.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def random_queries(n, num_kmers, term_size=31, seed=0xC0B5):
    rng = np.random.default_rng(seed)
    length = num_kmers + term_size - 1
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [bytes(alphabet[c]).decode() for c in codes]


def drive_direct(search, queries, threshold, limit, batch):
    t0 = time.perf_counter()
    n = 0
    for res in search.search_stream(queries, threshold, limit,
                                    batch_size=batch):
        n += 1
    dt = time.perf_counter() - t0
    return n / dt


def _client_proc(sock, qs, out_q, pin_core=None):
    """One fully-pipelined near-zero-CPU client in its OWN process.

    The clients share the host's cores with the server, so the bench
    client must cost ~nothing: requests are
    pre-encoded before the clock-relevant exchange and responses are
    COUNTED (newlines), not parsed, with the first/last line
    spot-validated. This measures the SERVER's capacity, which is what
    a deployment with remote clients sees.

    pin_core confines the client to one CPU (os.sched_setaffinity),
    leaving the remaining cores to the server — the probe for host
    CPU contention."""
    import json
    import os as os_mod
    import socket as socket_mod

    if pin_core is not None:
        os_mod.sched_setaffinity(0, {pin_core})

    payload = b"".join(
        json.dumps({"id": i, "query": q}).encode() + b"\n"
        for i, q in enumerate(qs))
    c = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    c.connect(sock)
    c.settimeout(600)
    import threading

    sender = threading.Thread(target=c.sendall, args=(payload,),
                              daemon=True)
    sender.start()
    n = 0
    first = b""
    while n < len(qs):
        chunk = c.recv(1 << 20)
        if not chunk:
            raise ConnectionError("server closed the connection")
        if not first:
            first = chunk
        n += chunk.count(b"\n")
    sender.join()
    c.close()
    assert n == len(qs), (n, len(qs))
    r0 = json.loads(first.split(b"\n", 1)[0])
    assert "results" in r0 or "error" in r0, r0
    out_q.put(n)


def drive_served(search, queries, threshold, limit, batch, clients,
                 linger_ms, warm, pin_clients=False):
    import multiprocessing as mp
    import os as _os
    import sys as _sys

    si = _os.environ.get("BENCH_SWITCHINTERVAL")
    if si:
        _sys.setswitchinterval(float(si))

    from cobs_tpu.query.server import QueryServer

    sock = str(Path(tempfile.mkdtemp()) / "bench.sock")
    srv = QueryServer(search, unix_path=sock, threshold=threshold,
                      num_results=limit, batch_size=batch,
                      linger_ms=linger_ms)
    per_client = [queries[i::clients] for i in range(clients)]

    # spawn, not fork: this process has opened the device and started
    # XLA's threads; the clients (this module's top level imports no
    # JAX) must not inherit them
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    with srv:
        # warm the socket path (the scoring programs are already
        # compiled by the caller's direct warmup)
        wp = ctx.Process(target=_client_proc, args=(sock, warm, out_q))
        wp.start()
        out_q.get()
        wp.join()
        ncpu = _os.cpu_count() or 4
        procs = [ctx.Process(target=_client_proc,
                             args=(sock, per_client[i], out_q,
                                   ncpu - 1 if pin_clients else None))
                 for i in range(clients)]
        t0 = time.perf_counter()
        for pr in procs:
            pr.start()
        total = sum(out_q.get() for _ in procs)
        dt = time.perf_counter() - t0
        for pr in procs:
            pr.join()
        p50, p99 = srv._latency_ms()
        t = search.timer_
        print(f"DIAG stats={dict(srv._stats)} "
              f"t_hashes={t.get('hashes'):.2f} t_io={t.get('io'):.2f} "
              f"t_fetch={t.get('add rows'):.2f} "
              f"t_sort={t.get('sort results'):.2f}", flush=True)
    assert total == len(queries), (total, len(queries))
    return len(queries) / dt, p50, p99


def main():
    p = argparse.ArgumentParser()
    p.add_argument("index")
    p.add_argument("-t", "--threshold", type=float, default=0.8)
    p.add_argument("-l", "--limit", type=int, default=100)
    p.add_argument("-b", "--batch", type=int, default=1024)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--queries", type=int, default=8192)
    p.add_argument("--kmers", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=256)
    p.add_argument("--linger-ms", type=float, default=5.0)
    p.add_argument("--streamed", action="store_true")
    p.add_argument("--pin-clients", action="store_true",
                   help="ALSO run a served pass with every client "
                        "pinned to the last CPU core (host CPU "
                        "contention probe)")
    p.add_argument("--skip-direct", action="store_true")
    args = p.parse_args()

    import cobs_tpu
    from cobs_tpu.settings import settings

    def open_search():
        return cobs_tpu.Search(
            args.index, streamed=True if args.streamed else False)

    queries = random_queries(args.queries, args.kmers)
    # enough to form full mega groups, so every power-of-two K variant
    # compiles outside the clock (a cold K-ladder compile inside the
    # measured window once hid a 7x difference)
    warm = queries[:min(max(args.warmup,
                            args.batch * 2 * settings.mega_batches),
                        len(queries))]

    base = f"batch={args.batch} limit={args.limit} " \
           f"kmers={args.kmers} queries={args.queries} " \
           f"backend={'streamed' if args.streamed else 'device'}"

    # ONE Search for both modes: a device index uploads once, and the
    # two modes are compared within one process
    s = open_search()
    for _ in s.search_stream(warm, args.threshold, args.limit,
                             batch_size=args.batch):
        pass

    direct_qps = None
    if not args.skip_direct:
        s.timer_.reset()
        direct_qps = drive_direct(s, queries, args.threshold,
                                  args.limit, args.batch)
        t = s.timer_
        print(f"DIAG direct t_hashes={t.get('hashes'):.2f} "
              f"t_io={t.get('io'):.2f} "
              f"t_fetch={t.get('add rows'):.2f} "
              f"t_sort={t.get('sort results'):.2f}", flush=True)
        print(f"RESULT mode=direct {base} "
              f"queries_per_s={direct_qps:.1f}", flush=True)
    s.timer_.reset()

    served_qps, p50, p99 = drive_served(
        s, queries, args.threshold, args.limit, args.batch,
        args.clients, args.linger_ms, warm)
    extra = ""
    if direct_qps:
        extra = (f" overhead_pct="
                 f"{100 * (1 - served_qps / direct_qps):.1f}")
    if args.pin_clients:
        s.timer_.reset()
        pq, pp50, pp99 = drive_served(
            s, queries, args.threshold, args.limit, args.batch,
            args.clients, args.linger_ms, warm, pin_clients=True)
        print(f"RESULT mode=served_pinned {base} "
              f"clients={args.clients} queries_per_s={pq:.1f} "
              f"lat_p50_ms={pp50} lat_p99_ms={pp99}", flush=True)
    print(f"RESULT mode=served {base} clients={args.clients} "
          f"linger_ms={args.linger_ms} "
          f"queries_per_s={served_qps:.1f} "
          f"lat_p50_ms={p50} lat_p99_ms={p99}{extra}", flush=True)


if __name__ == "__main__":
    main()
