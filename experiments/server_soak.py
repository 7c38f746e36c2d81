"""Serving soak: sustained exact traffic + live reloads + protocol chaos.

Drives a QueryServer for `--seconds` with, concurrently:
  - N pipelining clients asserting EVERY response exact against the
    embedded Search (ids round-trip, results bit-equal);
  - a reload client issuing {"cmd": "reload"} every second;
  - a chaos client opening connections, sending garbage / partial
    lines / oversized ids, and abandoning sockets mid-burst.

Exit code 0 = zero wrong responses, zero batch failures, zero leaked
connections. Re-run it after serving-stack changes — writer-side
rendering, native serialization, burst-sized send queues.

  JAX_PLATFORMS=cpu python experiments/server_soak.py --seconds 60
"""

import argparse
import json
import random
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GOLDEN = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--clients", type=int, default=4)
    args = ap.parse_args()

    import numpy as np

    import cobs_tpu
    from cobs_tpu.query.server import QueryServer

    tmp = Path(tempfile.mkdtemp())
    fasta = Path(__file__).resolve().parent.parent / "tests/data/fasta"
    idx = tmp / "soak.cobs_classic"
    cobs_tpu.settings.disable_cache = True
    cobs_tpu.classic_construct(
        cobs_tpu.DocumentList(fasta), idx,
        index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
    direct = cobs_tpu.Search(str(idx))
    # a query pool with known-exact expectations at several thresholds
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pool = [GOLDEN] + [bytes(bases[rng.integers(0, 4, size=60)]).decode()
                       for _ in range(15)]
    thresholds = [0.0, 0.3, 0.8]
    want = {(q, t): [[r.doc_name, r.score]
                     for r in direct.search(q, t)]
            for q in pool for t in thresholds}

    sock = str(tmp / "soak.sock")
    srv = QueryServer(
        cobs_tpu.Search(str(idx)), unix_path=sock, threshold=0.0,
        linger_ms=1.0,
        search_factory=lambda paths: cobs_tpu.Search(
            [str(p) for p in paths] if paths else str(idx)))
    stop = threading.Event()
    errs: list[str] = []
    counts = {"exact": 0, "reloads": 0, "chaos_conns": 0}
    lock = threading.Lock()

    def pipeliner(tag):
        r = random.Random(tag)
        try:
            c = socket.create_connection  # noqa: F841 (unix below)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(sock)
            s.settimeout(60)
            f = s.makefile("rb")
            while not stop.is_set():
                burst = [(i, r.choice(pool), r.choice(thresholds))
                         for i in range(r.randint(1, 64))]
                payload = b"".join(
                    json.dumps({"id": [tag, i], "query": q,
                                "threshold": t}).encode() + b"\n"
                    for i, q, t in burst)
                s.sendall(payload)
                for i, q, t in burst:
                    resp = json.loads(f.readline())
                    if resp.get("id") != [tag, i] or \
                            resp.get("results") != want[(q, t)]:
                        errs.append(f"mismatch {tag}/{i}: {resp}")
                        stop.set()
                        return
                with lock:
                    counts["exact"] += len(burst)
            s.close()
        except Exception as e:  # noqa: BLE001 - soak reports all
            if not stop.is_set():
                errs.append(f"pipeliner {tag}: {e!r}")
                stop.set()

    def reloader():
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(sock)
            s.settimeout(60)
            f = s.makefile("rb")
            while not stop.is_set():
                s.sendall(b'{"cmd": "reload", "id": "r"}\n')
                resp = json.loads(f.readline())
                if not resp.get("ok"):
                    errs.append(f"reload failed: {resp}")
                    stop.set()
                    return
                with lock:
                    counts["reloads"] += 1
                time.sleep(1.0)
            s.close()
        except Exception as e:  # noqa: BLE001
            if not stop.is_set():
                errs.append(f"reloader: {e!r}")
                stop.set()

    def chaos():
        r = random.Random(99)
        garbage = [b"not json\n", b'{"query": 5}\n', b"\n",
                   b'{"cmd": "nope"}\n', b'{"query": ""}\n',
                   b'{"id": ' + b"9" * 100 + b', "query": "ACGT"}\n',
                   b'{"query": "' + b"Z" * 80 + b'"}\n']
        while not stop.is_set():
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(sock)
                s.settimeout(5)
                for _ in range(r.randint(1, 5)):
                    s.sendall(r.choice(garbage))
                if r.random() < 0.5:
                    s.close()          # abandon mid-conversation
                else:
                    s.recv(4096)
                    s.close()
                with lock:
                    counts["chaos_conns"] += 1
            except OSError:
                pass
            time.sleep(0.01)

    with srv:
        threads = ([threading.Thread(target=pipeliner, args=(t,))
                    for t in range(args.clients)]
                   + [threading.Thread(target=reloader),
                      threading.Thread(target=chaos, daemon=True)])
        for t in threads:
            t.start()
        deadline = time.monotonic() + args.seconds
        while time.monotonic() < deadline and not stop.is_set():
            time.sleep(0.25)
        stop.set()
        for t in threads[:-1]:
            t.join(timeout=90)
        with srv._lock:
            stats = dict(srv._stats)
        conns = len(srv._conns)

    ok = (not errs and stats.get("batch_failures", 0) == 0
          and counts["exact"] > 0 and counts["reloads"] > 0)
    print(f"RESULT name=server_soak seconds={args.seconds} "
          f"exact_queries={counts['exact']} "
          f"reloads={counts['reloads']} "
          f"chaos_conns={counts['chaos_conns']} "
          f"bad_requests={stats.get('bad_requests', 0)} "
          f"query_errors={stats.get('query_errors', 0)} "
          f"batch_failures={stats.get('batch_failures', 0)} "
          f"overflowed={stats.get('overflowed_connections', 0)} "
          f"open_conns_at_close={conns} ok={ok}")
    for e in errs[:10]:
        print("ERR:", e, file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
