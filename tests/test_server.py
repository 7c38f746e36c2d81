"""QueryServer: the dynamic-batching serving front-end.

The reference has no resident server (its query loop is one-shot,
reference: src/cobs.cpp:471-527); the serving contract tested here is
that every protocol path returns exactly what the in-process `Search`
returns: golden parity through the socket, per-request refinement as
prefix cuts, per-query error isolation, concurrent clients.
"""

import json
import shutil
import socket
import threading
from pathlib import Path

import pytest

import cobs_tpu
from cobs_tpu.query.server import QueryServer
from cobs_tpu.settings import settings

DATA = Path(__file__).parent / "data"
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"


@pytest.fixture(autouse=True)
def _no_cache():
    settings.disable_cache = True
    yield
    settings.disable_cache = False


@pytest.fixture(scope="module")
def index_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server_idx")
    fasta = tmp / "fasta"
    shutil.copytree(DATA / "fasta", fasta)
    out = tmp / "idx.cobs_classic"
    settings.disable_cache = True
    try:
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(fasta), out,
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
    finally:
        settings.disable_cache = False
    return out


class Client:
    """Line-level JSON client; requests may be pipelined."""

    def __init__(self, address):
        if isinstance(address, str):
            self.sock = socket.socket(socket.AF_UNIX,
                                      socket.SOCK_STREAM)
        else:
            self.sock = socket.socket(socket.AF_INET,
                                      socket.SOCK_STREAM)
        self.sock.connect(address)
        self.sock.settimeout(60)
        self._rfile = self.sock.makefile("rb")

    def send(self, obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())

    def recv(self):
        line = self._rfile.readline()
        assert line, "server closed the connection"
        return json.loads(line)

    def ask(self, obj):
        self.send(obj)
        return self.recv()

    def close(self):
        self._rfile.close()
        self.sock.close()


def expected(search, query, threshold=0.0, num_results=0):
    return [[r.doc_name, r.score]
            for r in search.search(query, threshold, num_results)]


@pytest.fixture()
def served(index_file, tmp_path):
    """A running server at floor threshold 0 plus a direct Search."""
    s = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "cobs.sock"),
                      threshold=0.0, linger_ms=1.0)
    with srv:
        yield srv, cobs_tpu.Search(str(index_file))


def test_golden_query_through_socket(served):
    srv, direct = served
    c = Client(srv.address)
    r = c.ask({"id": 7, "query": GOLDEN_QUERY})
    assert r["id"] == 7
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    assert r["results"][0] == ["sample1", 20]
    c.close()


def test_per_request_threshold_and_limit(served):
    srv, direct = served
    c = Client(srv.address)
    # raising the threshold = prefix cut, exact vs direct search
    r = c.ask({"id": 1, "query": GOLDEN_QUERY, "threshold": 0.8})
    assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
    assert r["results"] == [["sample1", 20]]
    r = c.ask({"id": 2, "query": GOLDEN_QUERY, "num_results": 3})
    assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0, 3)
    assert len(r["results"]) == 3
    r = c.ask({"id": 3, "query": GOLDEN_QUERY, "threshold": 0.5,
               "num_results": 2})
    assert r["results"] == expected(direct, GOLDEN_QUERY, 0.5, 2)
    c.close()


def test_pipelined_requests_one_connection(served):
    srv, direct = served
    c = Client(srv.address)
    n = 10
    for i in range(n):
        c.send({"id": i, "query": GOLDEN_QUERY})
    got = [c.recv() for _ in range(n)]
    want = expected(direct, GOLDEN_QUERY)
    for i, r in enumerate(got):
        assert r["id"] == i
        assert r["results"] == want
    c.close()


def test_concurrent_clients(served):
    srv, direct = served
    want = expected(direct, GOLDEN_QUERY)
    errors = []

    def worker(tag):
        try:
            c = Client(srv.address)
            for i in range(8):
                r = c.ask({"id": [tag, i], "query": GOLDEN_QUERY})
                assert r["id"] == [tag, i]
                assert r["results"] == want
            c.close()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors


def test_bad_query_isolated(served):
    srv, _ = served
    c = Client(srv.address)
    c.send({"id": "short", "query": "ACGT"})         # too short
    c.send({"id": "bad", "query": "NNNNOTDNA" * 8})  # non-ACGT
    c.send({"id": "ok", "query": GOLDEN_QUERY})
    by_id = {}
    for _ in range(3):
        r = c.recv()
        by_id[r["id"]] = r
    assert "error" in by_id["short"]
    assert "error" in by_id["bad"]
    assert by_id["ok"]["results"][0] == ["sample1", 20]
    c.close()


def test_protocol_errors_and_control(served):
    srv, _ = served
    c = Client(srv.address)
    assert c.ask({"cmd": "ping", "id": 0}) == {"id": 0, "ok": True}
    r = c.ask({"id": 1})                     # missing query
    assert "error" in r
    c.sock.sendall(b"this is not json\n")
    assert "error" in c.recv()
    r = c.ask({"id": 2, "query": GOLDEN_QUERY, "threshold": -0.5})
    assert "must be in [0, 1]" in r["error"]
    r = c.ask({"id": "2b", "query": GOLDEN_QUERY, "threshold": 1.5})
    assert "must be in [0, 1]" in r["error"]
    st = c.ask({"cmd": "stats", "id": 3})
    assert st["queries"] == 0 and st["batches"] == 0  # none scored
    assert st["bad_requests"] >= 2
    assert "lat_p50_ms" not in st  # no samples yet
    r = c.ask({"id": 4, "query": GOLDEN_QUERY})
    assert r["results"]
    st = c.ask({"cmd": "stats", "id": 5})
    assert st["lat_p50_ms"] > 0 and st["lat_p99_ms"] >= st["lat_p50_ms"]
    c.close()


def test_subfloor_request_served_exactly(index_file, tmp_path):
    """A request below the server floor lowers its batch's rank
    threshold (slow path) and returns exactly the embedded Search's
    results at that threshold; floor-or-above traffic in the same
    session stays on the fast path and stays exact."""
    direct = cobs_tpu.Search(str(index_file))
    srv = QueryServer(cobs_tpu.Search(str(index_file)),
                      unix_path=str(tmp_path / "floor.sock"),
                      threshold=0.8, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        # fast path first: at and above the floor
        r = c.ask({"id": 0, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
        r = c.ask({"id": 1, "query": GOLDEN_QUERY, "threshold": 0.9})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.9)
        # sub-floor: full ranking at 0.0 through a 0.8-floor server
        r = c.ask({"id": 2, "query": GOLDEN_QUERY, "threshold": 0.0})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0)
        assert len(r["results"]) == 7
        r = c.ask({"id": 3, "query": GOLDEN_QUERY, "threshold": 0.05,
                   "num_results": 3})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.05, 3)
        # the fast path is untouched afterwards
        r = c.ask({"id": 4, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
        st = c.ask({"cmd": "stats", "id": 5})
        assert st["subfloor_batches"] >= 1
        assert st["subfloor_batches"] < st["batches"]
        c.close()


@pytest.fixture(scope="module")
def hetero_indices(tmp_path_factory):
    """Two indices over the same corpus with DIFFERENT term sizes —
    the mixed federation the reference serves via multi-index query
    (reference: cobs/query/classic_search.cpp:413-435)."""
    tmp = tmp_path_factory.mktemp("hetero_idx")
    fasta = tmp / "fasta"
    shutil.copytree(DATA / "fasta", fasta)
    out = []
    settings.disable_cache = True
    try:
        for k in (31, 21):
            p = tmp / f"idx{k}.cobs_classic"
            cobs_tpu.classic_construct(
                cobs_tpu.DocumentList(fasta), p,
                index_params=cobs_tpu.ClassicIndexParameters(
                    term_size=k, clobber=True))
            out.append(str(p))
    finally:
        settings.disable_cache = False
    return out


def test_heterogeneous_federation_per_request_threshold(
        hetero_indices, tmp_path):
    """On a mixed-term-size federation a per-request threshold is a
    PER-INDEX score floor (ceil(t * (|q| - ts + 1)) differs by index);
    the served refinement must equal the embedded Search at every
    threshold, above and below the floor."""
    direct = cobs_tpu.Search(hetero_indices)
    srv = QueryServer(cobs_tpu.Search(hetero_indices),
                      unix_path=str(tmp_path / "het.sock"),
                      threshold=0.5, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        for i, thr in enumerate([0.5, 0.8, 0.95, 0.2, 0.0]):
            r = c.ask({"id": i, "query": GOLDEN_QUERY,
                       "threshold": thr})
            assert r["results"] == \
                expected(direct, GOLDEN_QUERY, thr), f"thr={thr}"
        # threshold composes with a per-request result cap
        r = c.ask({"id": "cap", "query": GOLDEN_QUERY,
                   "threshold": 0.7, "num_results": 4})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.7, 4)
        c.close()


def test_cut_per_index_matches_filter():
    """ResultList.cut_per_index == per-entry filtering by the source
    index's floor, order preserved."""
    import numpy as np

    from cobs_tpu.query.search import ResultList

    rng = np.random.default_rng(5)
    names = [f"d{i}" for i in range(30)]
    bounds = np.asarray([10, 18, 30])  # three indices
    gidx = rng.permutation(30)
    scores = np.sort(rng.integers(0, 50, size=30))[::-1]
    # make it a validly-ranked list: score desc, gidx asc within ties
    order = np.lexsort((gidx, -scores))
    rl = ResultList(names, gidx[order], scores[order].astype(np.int64))
    mins = [10, 25, 40]
    got = rl.cut_per_index(bounds, mins)
    want = [(n, s) for n, s in
            zip([names[g] for g in rl._gidx], rl._scores.tolist())
            if s >= mins[int(np.searchsorted(bounds, int(n[1:]),
                                             side="right"))]]
    assert [(r.doc_name, r.score) for r in got] == want


def test_serve_forever_log_interval(index_file, tmp_path, capsys):
    import time

    s = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "lg.sock"),
                      threshold=0.0, linger_ms=1.0)
    t = threading.Thread(
        target=lambda: srv.serve_forever(log_interval=0.2),
        daemon=True)
    t.start()
    time.sleep(0.1)
    c = Client(srv.address)
    assert c.ask({"id": 0, "query": GOLDEN_QUERY})["results"]
    time.sleep(0.5)
    c.close()
    srv.close()
    t.join(timeout=30)
    out = capsys.readouterr().out  # stdout: the RESULT line protocol
    assert "RESULT queries_per_s=" in out and "queries=1" in out


def test_warmup_precompiles(index_file, tmp_path):
    s = cobs_tpu.Search(str(index_file))
    direct = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "w.sock"),
                      threshold=0.0, linger_ms=1.0)
    srv.warmup(len(GOLDEN_QUERY))
    with srv:
        c = Client(srv.address)
        r = c.ask({"id": 0, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY)
        c.close()
        with pytest.raises(RuntimeError, match="before start"):
            srv.warmup(50)


def test_protocol_fuzz(served, rng):
    """Random garbage interleaved with valid requests: every valid
    request gets its exact answer, the server never hangs."""
    srv, direct = served
    want = expected(direct, GOLDEN_QUERY)
    c = Client(srv.address)
    garbage = [
        b"\x00\xff\xfe garbage\n",
        b"[1, 2, 3]\n",
        b'"just a string"\n',
        b"{\n",
        b'{"query": 42}\n',
        b'{"query": ""}\n',
        b'{"cmd": "nonsense"}\n',
        b'{"query": "' + b"A" * 40 + b'", "threshold": "high"}\n',
        b'{"query": "' + b"A" * 40 + b'", "num_results": -3}\n',
    ]
    valid_ids = []
    k = 0
    for i in range(60):
        if rng.random() < 0.5:
            c.sock.sendall(garbage[int(rng.integers(len(garbage)))])
        else:
            c.send({"id": k, "query": GOLDEN_QUERY})
            valid_ids.append(k)
            k += 1
    # every line is either an error (garbage) or a valid result
    needed = set(valid_ids)
    for _ in range(70):  # every sent line produces <= 1 response
        if not needed:
            break
        r = c.recv()
        if r.get("id") in needed and "results" in r:
            assert r["results"] == want
            needed.discard(r["id"])
        else:
            assert "error" in r
    assert not needed
    assert c.ask({"cmd": "ping"})["ok"] is True
    c.close()


def test_topk_serving_mode(index_file, tmp_path):
    s = cobs_tpu.Search(str(index_file))
    direct = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "k.sock"),
                      threshold=0.0, num_results=5, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        r = c.ask({"id": 0, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0, 5)
        r = c.ask({"id": 1, "query": GOLDEN_QUERY, "num_results": 2})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0, 2)
        # the device cap is the ceiling in top-k mode
        r = c.ask({"id": 2, "query": GOLDEN_QUERY, "num_results": 99})
        assert "error" in r
        # per-request threshold composes with top-k (prefix cut on
        # the k-candidate list)
        r = c.ask({"id": 3, "query": GOLDEN_QUERY, "threshold": 0.8,
                   "num_results": 5})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8, 5)
        assert r["results"] == [["sample1", 20]]
        c.close()


def test_randomized_parity_with_direct(tmp_path, rng):
    """Protocol-layer analog of test_backends_agree: random corpus,
    random queries, several thresholds/limits — the served results
    must equal the embedded Search exactly."""
    from cobs_tpu.construct.classic import classic_construct_random
    from cobs_tpu.query.client import QueryClient
    from cobs_tpu.utils.misc import random_sequence_rng

    idx = tmp_path / "rand.cobs_classic"
    classic_construct_random(idx, signature_size=4096,
                             num_documents=64, document_size=200,
                             seed=11)
    direct = cobs_tpu.Search(str(idx))
    queries = [random_sequence_rng(int(rng.integers(40, 200)), rng)
               for _ in range(32)]
    srv = QueryServer(cobs_tpu.Search(str(idx)),
                      unix_path=str(tmp_path / "rp.sock"),
                      threshold=0.0, linger_ms=1.0, batch_size=8)
    with srv:
        with QueryClient(srv.address) as c:
            for thr, lim in ((0.0, 0), (0.0, 7), (0.5, 0), (0.9, 3)):
                got = c.search_batch(queries, threshold=thr,
                                     num_results=lim or None)
                want = direct.search_batch(queries, thr, lim)
                for g, w in zip(got, want):
                    assert [(r.doc_name, r.score) for r in g] == \
                        [(r.doc_name, r.score) for r in w], (thr, lim)


def test_randomized_hetero_parity_with_direct(tmp_path, rng):
    """Randomized served-vs-embedded parity over a MIXED-term-size
    federation, both serving modes, thresholds above and below the
    floor — the bug class where per-index refinement interacts with
    rank-time caps."""
    import numpy as np

    from cobs_tpu.query.client import QueryClient

    docs = tmp_path / "docs"
    docs.mkdir()
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(24):
        seq = bases[rng.integers(0, 4, size=250 + 17 * i)].tobytes()
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idxs = []
    for k in (31, 23):
        p = tmp_path / f"i{k}.cobs_classic"
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(docs), p,
            index_params=cobs_tpu.ClassicIndexParameters(
                term_size=k, clobber=True))
        idxs.append(str(p))
    direct = cobs_tpu.Search(idxs)
    queries = [bytes(bases[rng.integers(0, 4, size=n)]).decode()
               for n in rng.integers(40, 150, size=24)]
    for mode_limit in (0, 5):     # full-rank and top-k serving modes
        srv = QueryServer(cobs_tpu.Search(idxs),
                          unix_path=str(tmp_path
                                        / f"hr{mode_limit}.sock"),
                          threshold=0.3, num_results=mode_limit,
                          linger_ms=1.0, batch_size=8)
        with srv:
            with QueryClient(srv.address) as c:
                for thr in (0.0, 0.1, 0.3, 0.6, 0.9):
                    lim = mode_limit or 0
                    got = c.search_batch(
                        queries, threshold=thr,
                        num_results=mode_limit or None)
                    want = direct.search_batch(queries, thr, lim)
                    for q, g, w in zip(queries, got, want):
                        assert [(r.doc_name, r.score) for r in g] == \
                            [(r.doc_name, r.score) for r in w], \
                            (mode_limit, thr, q)


def test_tcp_endpoint_and_batching(index_file):
    s = cobs_tpu.Search(str(index_file))
    direct = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, port=0, threshold=0.0, batch_size=8,
                      linger_ms=20.0)
    with srv:
        host, port = srv.address
        c = Client((host, port))
        n = 8
        for i in range(n):
            c.send({"id": i, "query": GOLDEN_QUERY})
        want = expected(direct, GOLDEN_QUERY)
        for i in range(n):
            r = c.recv()
            assert r["id"] == i and r["results"] == want
        st = c.ask({"cmd": "stats"})
        # the linger window must coalesce pipelined requests
        assert st["batches"] < st["queries"]
        c.close()


def test_cli_serve_subprocess(index_file, tmp_path):
    """`cobs serve` end-to-end: spawn the CLI, query over the socket."""
    import os
    import subprocess
    import sys
    import time

    sock = tmp_path / "cli.sock"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cobs_tpu.cli.main", "serve",
         "-i", str(index_file), "--socket", str(sock),
         "-t", "0", "--linger-ms", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
    try:
        deadline = time.monotonic() + 120
        while not sock.exists():
            assert proc.poll() is None, "serve exited early"
            assert time.monotonic() < deadline, "socket never appeared"
            time.sleep(0.1)
        c = Client(str(sock))
        r = c.ask({"id": 0, "query": GOLDEN_QUERY, "threshold": 0.8})
        assert r["results"] == [["sample1", 20]]
        c.close()
        # SIGTERM = graceful drain-and-exit: rc 0, socket file removed
        proc.terminate()
        assert proc.wait(timeout=60) == 0
        deadline = time.monotonic() + 10
        while sock.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not sock.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_query_client(served):
    from cobs_tpu.query.client import (QueryClient, ServerError)
    from cobs_tpu.query.search import QueryError
    srv, direct = served
    with QueryClient(srv.address) as c:
        assert c.ping()
        hits = c.search(GOLDEN_QUERY, threshold=0.8)
        assert [(r.doc_name, r.score) for r in hits] == [("sample1", 20)]
        # drop-in parity with the embedded API
        assert hits == direct.search(GOLDEN_QUERY, 0.8)
        batch = c.search_batch([GOLDEN_QUERY, "ACGT", GOLDEN_QUERY],
                               num_results=2)
        assert batch[0] == direct.search(GOLDEN_QUERY, 0.0, 2)
        assert isinstance(batch[1], QueryError)
        assert batch[2] == batch[0]
        with pytest.raises(ServerError):
            c.search("ACGT")
        assert c.stats()["queries"] >= 4


def test_connection_cleanup(served):
    """Disconnected clients must not leak fds/threads/_conns entries."""
    import time

    srv, _ = served
    for _ in range(5):
        c = Client(srv.address)
        assert c.ask({"cmd": "ping"})["ok"] is True
        c.close()
    deadline = time.monotonic() + 10
    while srv._conns and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not srv._conns


def test_scorer_survives_internal_error(served, monkeypatch):
    """A scoring exception answers its batch and the server lives on."""
    srv, direct = served
    orig = srv.search._dispatch_async
    state = {"boomed": False}

    def boom(hashed, num_results):
        if not state["boomed"]:
            state["boomed"] = True
            raise RuntimeError("induced failure")
        return orig(hashed, num_results)

    monkeypatch.setattr(srv.search, "_dispatch_async", boom)
    c = Client(srv.address)
    r = c.ask({"id": 0, "query": GOLDEN_QUERY})
    assert "internal error" in r["error"]
    r = c.ask({"id": 1, "query": GOLDEN_QUERY})
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    st = c.ask({"cmd": "stats"})
    assert st["batch_failures"] == 1
    c.close()


def test_shared_client_across_threads(served):
    """One QueryClient shared by threads: calls serialize, stay correct."""
    from cobs_tpu.query.client import QueryClient
    srv, direct = served
    want = direct.search(GOLDEN_QUERY, 0.8)
    errors = []

    def worker(c):
        try:
            for _ in range(5):
                assert c.search(GOLDEN_QUERY, threshold=0.8) == want
        except Exception as e:
            errors.append(e)

    with QueryClient(srv.address) as c:
        ts = [threading.Thread(target=worker, args=(c,))
              for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    assert not errors


def test_server_streamed_backend(index_file, tmp_path):
    """The server over the host-mmap (bigger-than-HBM) backend."""
    s = cobs_tpu.Search(str(index_file), streamed=True)
    direct = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "st.sock"),
                      threshold=0.0, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        r = c.ask({"id": 0, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY)
        c.close()


def test_server_mesh_sharded(index_file, tmp_path):
    """The server over a mesh-sharded Search (synchronous scoring)."""
    import jax

    from cobs_tpu.parallel.sharded import make_mesh
    mesh = make_mesh(n_batch=1, n_docs=4, devices=jax.devices()[:4])
    s = cobs_tpu.Search(str(index_file), mesh=mesh)
    direct = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "m.sock"),
                      threshold=0.0, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        for i in range(3):
            r = c.ask({"id": i, "query": GOLDEN_QUERY,
                       "threshold": 0.8})
            assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
        c.close()


def test_reload_swaps_index_without_restart(tmp_path):
    """{"cmd": "reload"}: new index answers, old stays on failure."""
    from cobs_tpu.query.client import QueryClient, ServerError

    full = tmp_path / "full"
    shutil.copytree(DATA / "fasta", full)
    small = tmp_path / "small"
    small.mkdir()
    shutil.copy(full / "sample1.fasta", small / "sample1.fasta")
    idx_full = tmp_path / "full.cobs_classic"
    idx_small = tmp_path / "small.cobs_classic"
    for src, dst in ((full, idx_full), (small, idx_small)):
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(src), dst,
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True))

    def factory(paths=None):
        return cobs_tpu.Search([str(p) for p in paths] if paths
                               else [str(idx_full)])

    srv = QueryServer(factory(), unix_path=str(tmp_path / "r.sock"),
                      threshold=0.0, linger_ms=1.0,
                      search_factory=factory)
    with srv:
        with QueryClient(srv.address) as c:
            assert len(c.search(GOLDEN_QUERY)) == 7
            info = c.reload([str(idx_small)])
            assert info == {"documents": 1, "indices": 1}
            assert [(r.doc_name, r.score)
                    for r in c.search(GOLDEN_QUERY)] == [("sample1",
                                                          20)]
            # failed reload: error response, old (small) index lives
            with pytest.raises(ServerError, match="reload failed"):
                c.reload([str(tmp_path / "missing.cobs_classic")])
            assert len(c.search(GOLDEN_QUERY)) == 1
            # an explicit empty list must be an error, not a silent
            # reload of the original paths
            with pytest.raises(ServerError, match="non-empty"):
                c.reload([])
            # default paths = the factory's own (the full index)
            info = c.reload()
            assert info["documents"] == 7
            assert len(c.search(GOLDEN_QUERY)) == 7
            st = c.stats()
            assert st["reloads"] == 2 and st["failed_reloads"] == 1


def test_reload_unconfigured_is_an_error(served):
    from cobs_tpu.query.client import QueryClient, ServerError
    srv, _ = served
    with QueryClient(srv.address) as c:
        with pytest.raises(ServerError, match="not configured"):
            c.reload()


def test_server_on_compact_and_federation(tmp_path):
    fasta = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", fasta)
    compact = tmp_path / "idx.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(fasta), compact,
        index_params=cobs_tpu.CompactIndexParameters(clobber=True))
    direct = cobs_tpu.Search(str(compact))
    srv = QueryServer(cobs_tpu.Search(str(compact)),
                      unix_path=str(tmp_path / "c.sock"),
                      threshold=0.0, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        r = c.ask({"id": 0, "query": GOLDEN_QUERY, "threshold": 0.8})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
        c.close()

    # two-shard federation behind the server (the multi-host serving
    # shape: per-host sub-indices opened as one federated Search)
    d1, d2 = tmp_path / "d1", tmp_path / "d2"
    d1.mkdir(), d2.mkdir()
    samples = sorted(fasta.iterdir())
    for p in samples[:3]:
        shutil.copy(p, d1 / p.name)
    for p in samples[3:]:
        shutil.copy(p, d2 / p.name)
    i1, i2 = tmp_path / "s1.cobs_classic", tmp_path / "s2.cobs_classic"
    for src, dst in ((d1, i1), (d2, i2)):
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(src), dst,
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
    fed_direct = cobs_tpu.Search([str(i1), str(i2)])
    srv = QueryServer(cobs_tpu.Search([str(i1), str(i2)]),
                      unix_path=str(tmp_path / "f.sock"),
                      threshold=0.0, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        for thr in (0.0, 0.5, 0.8):
            r = c.ask({"id": thr, "query": GOLDEN_QUERY,
                       "threshold": thr})
            assert r["results"] == expected(fed_direct, GOLDEN_QUERY,
                                            thr)
        c.close()


def test_stall_breaker_rejects_new_queries(served, monkeypatch):
    """Liveness: when the scorer is blocked inside device work past
    stall_timeout (a device that stops answering does exactly this), NEW
    queries get an immediate 'server stalled' error instead of
    queueing forever; pre-stall requests still complete once the
    device recovers, and health clears."""
    import time

    srv, direct = served
    srv.stall_timeout_s = 0.3

    c = Client(srv.address)
    # warm: compiles + first-dispatch costs must not eat the timeout
    r = c.ask({"id": "warm", "query": GOLDEN_QUERY})
    assert r["results"]

    gate = threading.Event()
    orig = srv.search._finish_batch

    def blocked_finish(*a, **kw):
        assert gate.wait(60), "test gate never released"
        return orig(*a, **kw)

    monkeypatch.setattr(srv.search, "_finish_batch", blocked_finish)
    c.send({"id": "slow", "query": GOLDEN_QUERY})  # blocks the scorer
    time.sleep(0.8)  # > stall_timeout past the scorer's last progress

    c2 = Client(srv.address)
    r = c2.ask({"id": "rejected", "query": GOLDEN_QUERY})
    assert r["id"] == "rejected" and "stalled" in r["error"]
    st = c2.ask({"cmd": "stats"})  # control plane stays live
    assert st["stalled"] is True and st["stalled_rejects"] == 1

    gate.set()  # device "recovers": the blocked fetch drains
    r = c.recv()
    assert r["id"] == "slow"
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    deadline = time.monotonic() + 30
    while c2.ask({"cmd": "stats"})["stalled"]:
        assert time.monotonic() < deadline, "stall flag never cleared"
        time.sleep(0.02)
    r = c2.ask({"id": "after", "query": GOLDEN_QUERY})
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    c.close(), c2.close()


def test_large_pipelined_burst_single_connection(index_file, tmp_path):
    """A single connection pipelining more requests than several whole
    batches must receive every response (the send queue absorbs a full
    mega-group of back-to-back responses; regression: a fixed 1024
    queue closed healthy bulk clients)."""
    srv = QueryServer(cobs_tpu.Search(str(index_file)),
                      unix_path=str(tmp_path / "burst.sock"),
                      threshold=0.0, batch_size=8, linger_ms=1.0)
    assert srv._send_queue >= 2 * 8 * srv._mega
    with srv:
        c = Client(srv.address)
        n = srv._send_queue + 256  # strictly more than the queue
        for i in range(n):
            c.send({"id": i, "query": GOLDEN_QUERY})
        got = [c.recv() for _ in range(n)]
        assert [r["id"] for r in got] == list(range(n))
        assert all(r["results"][0] == ["sample1", 20] for r in got)
        st = c.ask({"cmd": "stats", "id": "s"})
        assert st["overflowed_connections"] == 0
        c.close()


def test_heterogeneous_topk_mode_per_request_threshold(tmp_path):
    """Top-k mode on a mixed-term-size federation: the per-index
    refinement must not lose entries to the merged floor-k cut (the
    server ranks with the full n_indices*k candidate budget and
    re-applies the cap after refinement). The corpus/seed are chosen
    so that capping at k BEFORE the per-index refinement provably
    diverges (query 8 at threshold 0.5 returns [] instead of a
    passing k=31 hit crowded out by higher-scoring-but-failing k=21
    entries) — mutation-checked."""
    import numpy as np

    rng = np.random.default_rng(42)
    docs = tmp_path / "docs"
    docs.mkdir()
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(32):
        seq = bases[rng.integers(0, 4, size=400)].tobytes()
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idxs = []
    for k in (31, 21):
        p = tmp_path / f"i{k}.cobs_classic"
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(docs), p,
            index_params=cobs_tpu.ClassicIndexParameters(
                term_size=k, clobber=True))
        idxs.append(str(p))
    direct = cobs_tpu.Search(idxs)
    queries = [bytes(bases[rng.integers(0, 4, size=70)]).decode()
               for _ in range(20)]
    # the embedded oracle for the known-divergent case
    assert [(r.doc_name, r.score)
            for r in direct.search(queries[8], 0.5, 4)] == [("d15", 21)]

    srv = QueryServer(cobs_tpu.Search(idxs),
                      unix_path=str(tmp_path / "hetk.sock"),
                      threshold=0.0, num_results=4, linger_ms=1.0)
    with srv:
        c = Client(srv.address)
        for qi, q in enumerate(queries):
            for thr in (0.0, 0.2, 0.35, 0.5):
                r = c.ask({"id": [qi, thr], "query": q,
                           "threshold": thr})
                assert r["results"] == expected(direct, q, thr, 4), \
                    (qi, thr)
        r = c.ask({"id": "k2", "query": queries[8],
                   "threshold": 0.5, "num_results": 2})
        assert r["results"] == expected(direct, queries[8], 0.5, 2)
        c.close()


def test_switch_interval_restored_on_close(index_file, tmp_path):
    import sys

    before = sys.getswitchinterval()
    srv = QueryServer(cobs_tpu.Search(str(index_file)),
                      unix_path=str(tmp_path / "si.sock"),
                      threshold=0.0)
    with srv:
        assert sys.getswitchinterval() <= 0.0005
    assert sys.getswitchinterval() == before


def test_slo_adaptive_mega_ceiling(index_file, tmp_path):
    """--slo-ms: a violated p99 target shrinks the deep-queue mega
    group cap toward per-batch dispatch (and caps the linger);
    lifting the SLO restores the full-throughput configuration.
    Results stay exact throughout."""
    import time

    s = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "slo.sock"),
                      threshold=0.0, linger_ms=50.0, batch_size=4,
                      slo_ms=0.001)   # any real latency violates
    with srv:
        direct = cobs_tpu.Search(str(index_file))
        assert srv._mega > 1, "mega-dispatch must be on for this test"
        # the 50 ms linger is capped to slo/8
        assert srv._linger_eff() <= srv.slo_ms / 8e3 + 1e-12
        c = Client(srv.address)
        want = expected(direct, GOLDEN_QUERY)
        deadline = time.monotonic() + 60
        shrunk = False
        while time.monotonic() < deadline and not shrunk:
            n = 64
            for i in range(n):
                c.send({"id": i, "query": GOLDEN_QUERY})
            for _ in range(n):
                assert c.recv()["results"] == want
            st = c.ask({"cmd": "stats"})
            shrunk = (st["slo_shrinks"] >= 1
                      and st["mega_effective"] == 1)
        assert shrunk, "SLO violation never shrank the mega ceiling"
        # lifting the SLO restores the static ceiling immediately
        srv.slo_ms = 0.0
        st = c.ask({"cmd": "stats"})
        assert st["mega_effective"] == srv._mega
        c.close()


def test_slo_aimd_growth_and_shrink(index_file, tmp_path):
    """AIMD dynamics of _slo_adjust: a p99 comfortably under the
    target grows the ceiling back one step at a time to the static
    cap; a violating window halves it."""
    s = cobs_tpu.Search(str(index_file))
    srv = QueryServer(s, unix_path=str(tmp_path / "slo2.sock"),
                      threshold=0.0, slo_ms=1000.0)
    with srv:  # idle server: the scorer never calls _slo_adjust
        srv._mega_eff = 1

        def feed(samples):
            # what _emit_ranked does: samples + the freshness counter
            srv._lat.extend(samples)
            srv._lat_count += len(samples)

        feed([1.0] * 64)                 # p99 = 1 ms << 0.7 * 1000
        for step in range(1, srv._mega):
            srv._slo_last = 0.0          # bypass the 250 ms pacing
            feed([1.0] * 32)             # adjustments need fresh samples
            srv._slo_adjust()
            assert srv._mega_eff == 1 + step
        assert srv._mega_eff == srv._mega
        srv._slo_last = 0.0
        srv._slo_adjust()                # NO fresh samples: no change
        assert srv._mega_eff == srv._mega
        feed([5000.0] * 256)             # violating window
        srv._slo_last = 0.0
        srv._slo_adjust()
        assert srv._mega_eff == max(1, srv._mega // 2)
        # the SAME stale window must not cascade a second halving
        srv._slo_last = 0.0
        srv._slo_adjust()
        assert srv._mega_eff == max(1, srv._mega // 2)
