"""Production serving front-end: a dynamic-batching query server.

The reference is a one-shot CLI — its query loop lives and dies inside
a single process invocation (reference: src/cobs.cpp:471-527).
Production serving wants the opposite: a resident process that keeps
the index in device memory, coalesces concurrent client queries into
device-sized batches (batch size is the serving lever), and keeps a
bounded window of batches in flight so ranking batch k overlaps
scoring batch k+1.

`QueryServer` provides that over a newline-delimited JSON protocol on
a Unix domain socket or TCP:

  request : {"query": "ACGT...", "id": <any>, "threshold": <float>,
             "num_results": <int>}            (id/threshold/limit optional)
  response: {"id": ..., "results": [[doc_name, score], ...]}
          | {"id": ..., "error": "message"}
  control : {"cmd": "ping"}  -> {"ok": true}
            {"cmd": "stats"} -> {"queries": N, "batches": N, ...}

Batching: requests arriving within `linger_ms` of the first one
coalesce into a batch of up to `batch_size` queries. When the queue
runs deeper than one batch, up to `settings.mega_batches` full batches
pack into ONE device program (mega-dispatch, engine.score_*_multi_
async) — the fixed per-dispatch+fetch cost divides by the group
size, while shallow
queues keep single-batch dispatch for bounded latency. The scorer
ranks every batch once at the server's configured floor (threshold
`t_floor`, result cap `limit`); a request may RAISE the threshold or
LOWER the cap — both are prefix cuts on the (score desc, doc asc)-
sorted list (`ResultList.cut`), bit-exact by construction. A request
BELOW the floor lowers its whole batch's rank threshold instead (a
slow path: a bigger ranked list, same single device program), and on
mixed-term-size federations a raised threshold refines with a
per-index score floor (`ResultList.cut_per_index`) — both exactly
match what the embedded `Search` returns.

Backpressure and isolation: each connection gets a reader thread and
a bounded outbound queue drained by a writer thread, so one slow
client stalls only itself, never the scorer. An invalid query yields
an error response in its own slot; the rest of its batch scores
normally (`Search._hash_batch_lenient`).
"""

import collections
import json
import math
import os
import queue
import socket
import threading
import time

from cobs_tpu.query.search import QueryError, Search
from cobs_tpu.utils.timer import Timer

_STOP = object()


class _LazyResult:
    """A result response rendered on the CONNECTION WRITER thread:
    serialization (native ResultFormatter, json.dumps fallback) then
    overlaps the scorer's device dispatch/fetch waits instead of
    stealing scorer time."""

    __slots__ = ("rid", "res", "fmt")

    def __init__(self, rid, res, fmt):
        self.rid = rid
        self.res = res
        self.fmt = fmt

    def render(self) -> bytes:
        frag = self.res.serialize_with(self.fmt)
        if frag is None:
            return (json.dumps({"id": self.rid,
                                "results": self.res.pairs()})
                    + "\n").encode()
        return (b'{"id": %s, "results": %s}\n'
                % (json.dumps(self.rid).encode(), frag))


class _Reload:
    """Control item: swap the index set between batches."""

    __slots__ = ("conn", "rid", "paths")

    def __init__(self, conn, rid, paths):
        self.conn = conn
        self.rid = rid
        self.paths = paths


class _Conn:
    """One client connection: bounded outbound queue + writer thread.

    The scorer never blocks on a client socket: `send` enqueues raw
    objects (JSON serialization happens on the writer thread, off the
    scorer), and a full queue — a client that pipelines faster than it
    reads — closes that connection rather than silently dropping
    individual responses: the protocol is one response per request,
    so a gap would desync the client forever, while a closed socket
    is an observable error.
    """

    def __init__(self, sock, server):
        self.sock = sock
        self.server = server
        self.alive = True
        # sized to absorb a full mega-group of responses enqueued
        # back-to-back by the scorer (rendering happens lazily on THIS
        # connection's writer thread, so the scorer's enqueue burst is
        # instantaneous): a queue smaller than one burst would close
        # healthy pipelining clients. Overflow still means a client
        # persistently slower than the scorer -> close (the protocol
        # is one response per request; dropping would desync forever).
        self._outq = queue.Queue(server._send_queue)
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True)
        self._writer.start()

    def send(self, obj) -> None:
        if not self.alive:
            return
        try:
            self._outq.put_nowait(obj)
        except queue.Full:
            self.server._count("overflowed_connections")
            self.close()

    def _write_loop(self):
        stop = False
        while not stop:
            obj = self._outq.get()
            if obj is _STOP:
                break
            # coalesce everything already queued into one write: a
            # scored batch enqueues its responses back-to-back, and
            # per-response sendall syscalls + thread wakeups measurably
            # bound served throughput once scoring is fast
            batch = [obj]
            while len(batch) < 512:
                try:
                    nxt = self._outq.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            if not self.alive:
                continue  # drain without sending; producers never block
            try:
                payload = b"".join(
                    o.render() if isinstance(o, _LazyResult)
                    else (json.dumps(o) + "\n").encode()
                    for o in batch)
            except Exception:  # a render bug must not kill the
                # writer thread silently (a dead writer = a hung
                # connection); close the SOCKET so the client observes
                # it (alive=False alone would leave readers blocked)
                self.server._count("batch_failures")
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.alive = False
                continue
            try:
                self.sock.sendall(payload)
            except OSError:
                self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass

    def finish(self, timeout: float = 10.0) -> None:
        """Graceful close: flush queued responses, then close.

        Used at server shutdown so responses the scorer already
        enqueued reach their clients; falls back to the abortive
        close() if the writer cannot drain in time (stalled client).
        """
        try:
            self._outq.put_nowait(_STOP)
        except queue.Full:
            self.close()
            return
        self._writer.join(timeout)
        if self._writer.is_alive():
            self.close()
        else:
            self.alive = False

    def close(self):
        self.alive = False
        # full shutdown unblocks a writer stuck in sendall() to a
        # stalled client, so close() can never hang behind it
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        while True:
            try:
                self._outq.put_nowait(_STOP)
                return
            except queue.Full:
                try:
                    self._outq.get_nowait()
                except queue.Empty:
                    pass


class QueryServer:
    """Serve one or more indices over a socket with dynamic batching.

    Parameters
    ----------
    search : Search | index path(s)
        An open `Search` (any backend: device, streamed, mesh-sharded)
        or anything its constructor accepts.
    unix_path : str | None
        Serve on a Unix domain socket at this path...
    host, port : TCP endpoint used when `unix_path` is None. port=0
        picks a free port (see `.address`).
    batch_size : max queries coalesced into one device batch.
    linger_ms : how long the batcher waits for stragglers after the
        first query of a batch arrives. 0 = score singletons
        immediately (lowest latency, lowest throughput).
    threshold : the server's score floor (reference default 0.8) —
        the threshold batches are ranked at. Per-request thresholds
        above it are prefix cuts (fast); below it, the request's batch
        ranks at the lower threshold (slow path, exact).
    num_results : 0 = full ranking; k > 0 = device top-k serving mode
        (per-request caps must be <= k).
    depth : dispatched-ahead batch window (bounded, so the device
        buffers held by unfetched batches stay bounded too).
    search_factory : callable(paths | None) -> Search, optional.
        Enables `{"cmd": "reload"}`: rebuild the index (same paths, or
        the request's "indices" list) and swap it in without dropping
        the process, the sockets, or any queued request. The load runs
        on the scorer thread between batches — serving pauses rather
        than overlapping a large upload with dispatches, which would
        need room for two indexes in device memory at once.
    stall_timeout : liveness breaker, seconds (0 disables). A device
        that stops answering (a hung kernel, a driver fault, a device
        held by another process) blocks the scorer inside a dispatch
        or fetch indefinitely; once
        the scoring pipeline has made no progress for this long, NEW
        query requests are answered immediately with a "server
        stalled" error instead of queueing forever. Requests accepted
        before the stall stay queued and are served when the device
        recovers; control commands (ping/stats) keep working
        throughout. Must exceed the slowest legitimate pause — a cold
        jit compile or a full index reload (default 300 s).
    slo_ms : optional p99 latency target, milliseconds (0 disables).
        Mega-dispatch trades latency for throughput: a deep queue
        packs up to `settings.mega_batches` batches per device
        program, and every response in the group waits for the whole
        program. With an SLO set, the group ceiling adapts (AIMD on
        the rolling p99, see `_slo_adjust`) and the batch linger is
        capped at slo/8 — throughput degrades gracefully to what the
        latency budget affords instead of the reverse.
    """

    def __init__(self, search, *, unix_path=None, host="127.0.0.1",
                 port=0, batch_size=64, linger_ms=2.0, threshold=0.8,
                 num_results=0, depth=2, search_factory=None,
                 stall_timeout=300.0, slo_ms=0.0):
        if not (0.0 <= threshold <= 1.0):
            raise ValueError("threshold must be in [0, 1]")
        if slo_ms < 0:
            raise ValueError("slo_ms must be >= 0")
        self.t_floor = float(threshold)
        self.limit = int(num_results)
        self.batch_size = int(batch_size)
        self.linger_s = float(linger_ms) / 1e3
        self.depth = int(depth)
        self.stall_timeout_s = float(stall_timeout)
        # latency SLO (p99 target, ms; 0 = pure-throughput mode): the
        # mega-dispatch ceiling becomes ADAPTIVE — a deep queue grows
        # device programs (and thus tail latency) only while the
        # rolling p99 stays under the target (_slo_adjust); the batch
        # linger is capped to a small fraction of the target too
        self.slo_ms = float(slo_ms)
        self._slo_last = 0.0
        self._lat_count = 0     # cumulative samples (AIMD freshness)
        self._slo_seen = 0      # _lat_count at the last adjustment
        # monotonic stamp of the scorer's latest progress; None = idle.
        # Stale while the scorer is blocked inside device work (float
        # read/write is atomic — intake reads it lock-free).
        self._busy_since = None
        self._factory = search_factory
        self._bind_search(search if isinstance(search, Search)
                          else Search(search))

        self.unix_path = unix_path
        if unix_path is not None:
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            if os.path.exists(unix_path):
                os.unlink(unix_path)
            self._listener.bind(unix_path)
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
        self._listener.listen(64)

        self._rq = queue.Queue()
        self._conns: list[_Conn] = []
        self._lock = threading.Lock()
        self._stats = collections.Counter()
        # rolling end-to-end (intake -> response enqueue) latencies, ms
        self._lat = collections.deque(maxlen=4096)
        self._started = False
        self._closed = False

    def _bind_search(self, search: Search) -> None:
        """Adopt `search` as the serving index set (init + reload)."""
        if not search.index_files:
            raise ValueError("QueryServer needs at least one index")
        term_sizes = {ix.term_size for ix in search.index_files}
        # uniform term size: per-request thresholds are one prefix cut;
        # heterogeneous federations refine with a per-index score floor
        # (ResultList.cut_per_index) instead
        self._uniform_ts = (term_sizes.pop()
                            if len(term_sizes) == 1 else None)
        self._term_sizes = [ix.term_size for ix in search.index_files]
        import numpy as np

        self._doc_bounds = np.cumsum(
            [len(ix.file_names) for ix in search.index_files])
        self._total_docs = sum(len(ix.file_names)
                               for ix in search.index_files)
        # deep-queue mega-dispatch ceiling (1 = per-batch dispatch),
        # HBM-capped for full-rank federations — recomputed on reload
        # because the backend kind may change; the formula lives on
        # Search so the served and embedded paths can never diverge
        self._mega = search._mega_k_capped(self.batch_size, self.limit)
        # adaptive ceiling under an SLO (scorer-thread-owned; starts
        # optimistic and shrinks on p99 violations)
        self._mega_eff = self._mega
        self._send_queue = max(1024,
                               2 * self.batch_size * self._mega + 64)
        # a reload may RAISE the burst size (e.g. streamed -> device
        # backend): live connections must grow their queues or the
        # first mega burst would close them as overflowed
        conns = getattr(self, "_conns", None)
        if conns is not None:
            with self._lock:
                for c in conns:
                    c._outq.maxsize = max(c._outq.maxsize,
                                          self._send_queue)
        # native GIL-free response serializer (json.dumps of a k=100
        # response costs ~40 us and capped the server at ~25k
        # responses/s/core); None -> json.dumps fallback in _emit_ranked
        from cobs_tpu import native

        self._fmt = native.ResultFormatter(search._names)
        self.search = search

    # ------------------------------------------------------------ public

    @property
    def address(self):
        """The bound endpoint: unix path or (host, port)."""
        return self.unix_path if self.unix_path is not None \
            else self._listener.getsockname()

    def start(self) -> None:
        """Start the accept loop and the scorer thread (non-blocking)."""
        if self._started:
            return
        import sys

        # the scorer's dispatch path is many short GIL-held numpy steps;
        # with per-connection reader/writer threads also CPU-active, the
        # default 5 ms GIL switch interval convoys each handoff into
        # milliseconds. Serving favors scorer latency over raw
        # background-thread throughput.
        if sys.getswitchinterval() > 0.0005:
            self._prev_switchinterval = sys.getswitchinterval()
            sys.setswitchinterval(0.0005)
        self._started = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._scorer_thread = threading.Thread(target=self._scorer,
                                               daemon=True)
        self._accept_thread.start()
        self._scorer_thread.start()

    def warmup(self, query_len: int, mega: bool = True) -> None:
        """Pre-compile the scoring program for this server's batch
        size and a `query_len`-character query (a cold compile takes
        seconds — pay it at deploy time, not on the first client's
        request). Call before `start()`.

        With `mega` (default) every power-of-two mega-dispatch variant
        up to `settings.mega_batches` is compiled too, so a traffic
        burst never stalls the scorer behind a cold compile."""
        import numpy as np

        if self._started:
            raise RuntimeError("warmup() must run before start()")
        from cobs_tpu.utils.misc import random_sequence_rng

        ts = max(ix.term_size for ix in self.search.index_files)
        query_len = max(int(query_len), ts)
        rng = np.random.default_rng(0xC0B5)
        qs = [random_sequence_rng(query_len, rng)
              for _ in range(self.batch_size)]
        self.search.search_batch(qs, self.t_floor, self.limit)
        if not mega or self._mega <= 1:
            return
        s = self.search
        qbytes = [q.encode() for q in qs]
        t = Timer()
        hashed, errors = s._hash_batch_lenient(qbytes, t)
        K = 2
        while K <= self._mega:
            pendings = s._dispatch_multi_async([hashed] * K,
                                               self.limit)
            s._finish_batch(qbytes, errors, pendings[-1],
                            self.t_floor, self.limit,
                            self._total_docs)
            K *= 2

    def serve_forever(self, log_interval: float = 0.0) -> None:
        """start() and block until close() (for the CLI).

        log_interval > 0 prints a RESULT line (the reference's
        benchmark line protocol, reference: src/cobs.cpp:647-662)
        every that-many seconds with the interval's throughput and
        the cumulative counters.
        """
        self.start()
        if log_interval <= 0:
            self._scorer_thread.join()
            return
        last_q = 0
        last_t = time.monotonic()
        while self._scorer_thread.is_alive():
            self._scorer_thread.join(timeout=log_interval)
            if not self._scorer_thread.is_alive():
                break
            with self._lock:
                st = dict(self._stats)
            now = time.monotonic()
            q = st.get("queries", 0)
            qps = (q - last_q) / max(now - last_t, 1e-9)
            p50, p99 = self._latency_ms()
            lat = (f"lat_p50_ms={p50} lat_p99_ms={p99} "
                   if p50 is not None else "")
            print(f"RESULT queries_per_s={qps:.1f} {lat}queries={q} "
                  f"batches={st.get('batches', 0)} "
                  f"conns={len(self._conns)} "
                  f"query_errors={st.get('query_errors', 0)} "
                  f"bad_requests={st.get('bad_requests', 0)} "
                  f"batch_failures={st.get('batch_failures', 0)} "
                  f"stalled={int(self._stall_seconds() > 0)}",
                  flush=True)  # stdout: the RESULT line protocol the
            # benchmark harness greps (cf. benchmark-fpr, timer.py)
            last_q, last_t = q, now

    def close(self) -> None:
        """Stop accepting, flush in-flight batches, shut down."""
        if self._closed:
            return
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        if self._started:
            self._rq.put(_STOP)
            self._scorer_thread.join(timeout=60)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # flush responses the scorer enqueued before closing —
            # a graceful shutdown must not drop already-scored work
            c.finish()
        if self.unix_path is not None and os.path.exists(self.unix_path):
            os.unlink(self.unix_path)
        prev = getattr(self, "_prev_switchinterval", None)
        if prev is not None:
            # the interval is process-global: an embedding application
            # must not inherit serving's scheduling bias after close()
            import sys

            sys.setswitchinterval(prev)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- intake

    def _count(self, key, n=1):
        with self._lock:
            self._stats[key] += n

    def _stall_seconds(self) -> float:
        """Seconds past the stall timeout the scorer has been blocked
        without progress; 0.0 while healthy, idle, or disabled."""
        if self.stall_timeout_s <= 0:
            return 0.0
        busy = self._busy_since
        if busy is None:
            return 0.0
        blocked = time.monotonic() - busy
        return blocked if blocked > self.stall_timeout_s else 0.0

    def _mega_ceiling(self) -> int:
        """Effective mega-dispatch group cap for this pass: the static
        HBM/settings ceiling, tightened adaptively under an SLO."""
        return self._mega_eff if self.slo_ms > 0 else self._mega

    def _linger_eff(self) -> float:
        """Batch linger, capped to 1/8 of the SLO target when one is
        set (lingering is pure added latency on a shallow queue)."""
        if self.slo_ms <= 0:
            return self.linger_s
        return min(self.linger_s, self.slo_ms / 8e3)

    def _slo_adjust(self) -> None:
        """AIMD control of the mega ceiling from the rolling p99
        (scorer thread only): a p99 above the SLO halves the group
        cap — each response's queue+device latency scales with the
        batches packed per program — and a p99 comfortably under it
        (<70%) grows the cap back one step, restoring throughput once
        the load allows. Each adjustment requires FRESH evidence: at
        most one per 250 ms AND >= 32 new samples since the last one,
        judged over only those new samples — otherwise one transient
        slow group would stay the last-256 window at low request
        rates and cascade multiple halvings."""
        if self.slo_ms <= 0:
            return
        now = time.monotonic()
        if now - self._slo_last < 0.25:
            return
        with self._lock:
            fresh = self._lat_count - self._slo_seen
            if fresh < 32:
                return
            recent = list(self._lat)[-min(256, fresh):]
        self._slo_last = now
        self._slo_seen = self._lat_count
        if not recent:
            return
        recent.sort()
        p99 = recent[min(len(recent) - 1, int(len(recent) * 0.99))]
        if p99 > self.slo_ms and self._mega_eff > 1:
            self._mega_eff = max(1, self._mega_eff // 2)
            self._count("slo_shrinks")
        elif p99 < 0.7 * self.slo_ms and self._mega_eff < self._mega:
            self._mega_eff += 1
            self._count("slo_grows")

    def _latency_ms(self):
        """(p50, p99) over the rolling window, or (None, None)."""
        with self._lock:  # scorer extends concurrently
            samples = sorted(self._lat)
        if not samples:
            return None, None
        n = len(samples)
        return (round(samples[n // 2], 2),
                round(samples[min(n - 1, int(n * 0.99))], 2))

    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            conn = _Conn(sock, self)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    MAX_LINE = 64 << 20  # a 100k-term query is ~100 KB; 64 MB is ample

    def _read_loop(self, conn):
        f = conn.sock.makefile("rb")
        try:
            while True:
                line = f.readline(self.MAX_LINE + 1)
                if not line:
                    break
                if len(line) > self.MAX_LINE:
                    conn.send({"id": None,
                               "error": "request line too long"})
                    break
                if not line.strip():
                    continue
                self._handle_line(conn, line)
        except OSError:
            pass
        finally:
            # a finished client must not leak its fd, writer thread,
            # or _conns entry across a long-running server's lifetime
            conn.close()
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass

    def _handle_line(self, conn, line):
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            self._count("bad_requests")
            conn.send({"id": None, "error": f"bad request: {e}"})
            return
        rid = req.get("id")
        cmd = req.get("cmd")
        if cmd == "ping":
            conn.send({"id": rid, "ok": True})
            return
        if cmd == "stats":
            st = {k: 0 for k in ("queries", "batches", "query_errors",
                                 "bad_requests", "batch_failures",
                                 "overflowed_connections", "reloads",
                                 "failed_reloads", "stalled_rejects",
                                 "mega_dispatches",
                                 "subfloor_batches", "slo_shrinks",
                                 "slo_grows")}
            with self._lock:
                st.update(self._stats)
            st["stalled"] = self._stall_seconds() > 0
            st["mega_effective"] = self._mega_ceiling()
            p50, p99 = self._latency_ms()
            if p50 is not None:
                st["lat_p50_ms"] = p50
                st["lat_p99_ms"] = p99
            st["id"] = rid
            conn.send(st)
            return
        if cmd == "reload":
            if self._factory is None:
                conn.send({"id": rid, "error":
                           "server not configured for reload (no "
                           "search_factory; `cobs serve` sets one)"})
                return
            paths = req.get("indices")
            if paths is not None and (
                    not isinstance(paths, list) or not paths
                    or not all(isinstance(p, str) for p in paths)):
                conn.send({"id": rid, "error":
                           "'indices' must be a non-empty list of "
                           "paths (omit it to reload the original "
                           "set)"})
                return
            self._rq.put(_Reload(conn, rid, paths))
            return
        if cmd is not None:
            conn.send({"id": rid, "error": f"unknown cmd {cmd!r}"})
            return

        query = req.get("query")
        if not isinstance(query, str) or not query:
            self._count("bad_requests")
            conn.send({"id": rid,
                       "error": "request needs a non-empty "
                                "string 'query'"})
            return
        thr = req.get("threshold", self.t_floor)
        lim = req.get("num_results", self.limit)
        try:
            thr = float(thr)
            lim = int(lim)
        except (TypeError, ValueError):
            conn.send({"id": rid, "error": "threshold must be a "
                       "number, num_results an integer"})
            return
        if not (0.0 <= thr <= 1.0):
            conn.send({"id": rid, "error":
                       "threshold must be in [0, 1]"})
            return
        if self.limit > 0 and (lim <= 0 or lim > self.limit):
            conn.send({"id": rid, "error":
                       f"num_results must be in 1..{self.limit} "
                       "(server runs in top-k mode)"})
            return
        if lim < 0:
            conn.send({"id": rid, "error": "num_results must be >= 0"})
            return
        stall = self._stall_seconds()
        if stall > 0:
            self._count("stalled_rejects")
            conn.send({"id": rid, "error":
                       f"server stalled: scoring pipeline blocked for "
                       f"{stall:.0f}s (device stall or index reload); "
                       "retry later"})
            return
        self._rq.put((conn, rid, query, thr, lim, time.monotonic()))

    # ----------------------------------------------------------- scorer

    def _next_batch(self, block):
        """Assemble one batch: first item per `block`, then linger.

        Returns (items, stopping, reload): items may be empty when not
        blocking and the queue is idle; stopping=True once _STOP is
        seen; a _Reload ends batch assembly (it applies after this
        batch and the in-flight window drain).
        """
        items = []
        try:
            first = self._rq.get(block=block)
        except queue.Empty:
            return items, False, None
        if first is _STOP:
            return items, True, None
        if isinstance(first, _Reload):
            return items, False, first
        items.append(first)
        deadline = time.monotonic() + self._linger_eff()
        while len(items) < self.batch_size:
            wait = deadline - time.monotonic()
            try:
                nxt = self._rq.get(block=wait > 0,
                                   timeout=wait if wait > 0 else None)
            except queue.Empty:
                break
            if nxt is _STOP:
                return items, True, None
            if isinstance(nxt, _Reload):
                return items, False, nxt
            items.append(nxt)
        return items, False, None

    def _scorer(self):
        """The serving loop: batch -> hash -> dispatch ahead -> rank.

        Single-threaded device interaction (dispatch and fetch both
        happen here) with a bounded in-flight window, mirroring
        `Search.search_stream`; unlike the stream, an idle request
        queue immediately drains the window instead of waiting for the
        next batch, so sparse traffic sees latency = device time, not
        window depth.
        """
        import time as _time

        dbg = os.environ.get("COBS_TPU_SERVER_DEBUG")

        def _mark(key, t0):
            t1 = _time.perf_counter()
            if dbg:
                with self._lock:
                    self._stats[key] += t1 - t0
            return t1

        inflight = collections.deque()
        stopping = False
        reload_req = None
        while True:
            t0 = _time.perf_counter()
            items = []
            if not stopping and reload_req is None:
                block = not inflight
                if block:
                    self._busy_since = None  # idle: nothing in flight
                items, stopping, reload_req = \
                    self._next_batch(block=block)
            t0 = _mark("t_assemble", t0)
            # every pass through here is progress; a scorer blocked
            # inside a dispatch/fetch/reload below lets this stamp go
            # stale, which intake reads as a stall (_stall_seconds)
            self._busy_since = time.monotonic()
            if not items:
                if inflight:
                    self._emit_safe(inflight.popleft())
                    _mark("t_drain_idle", t0)
                    continue
                if reload_req is not None:
                    # window drained: no pending batch references the
                    # old index — safe to swap (the loop holds no
                    # other reference, so the old index's device
                    # buffers free before the new one loads)
                    self._do_reload(reload_req)
                    reload_req = None
                    continue
                if stopping:
                    return
                continue
            # deep queue: assemble up to _mega additional FULL batches
            # (each available without lingering) and pack the group
            # into one device program — the fixed per-dispatch+fetch
            # cost divides by the group size. Shallow queues keep
            # single-batch dispatch, so latency stays bounded.
            groups = [items]
            while (not stopping and reload_req is None
                   and len(groups) < self._mega_ceiling()
                   and len(groups[-1]) == self.batch_size
                   and self._rq.qsize() >= self.batch_size):
                more, stopping, reload_req = \
                    self._next_batch(block=False)
                if more:
                    groups.append(more)
                else:
                    break
            t0 = _mark("t_group", t0)
            try:
                s = self.search
                hashed_group, metas = [], []
                for g_items in groups:
                    qbytes = [it[2].encode() for it in g_items]
                    t = Timer()
                    hashed, errors = s._hash_batch_lenient(qbytes, t)
                    s.timer_.merge(t)
                    hashed_group.append(hashed)
                    metas.append((g_items, qbytes, errors))
                self._count("batches", len(groups))
                self._count("queries",
                            sum(len(g) for g in groups))
                if len(groups) > 1:
                    self._count("mega_dispatches")
                t0 = _mark("t_hash", t0)
                pendings = s._dispatch_group_async(hashed_group,
                                                   self.limit)
                t0 = _mark("t_dispatch", t0)
                for (g_items, qbytes, errors), pd in zip(metas,
                                                         pendings):
                    # sub-floor requests lower the whole batch's rank
                    # threshold (slow path: a bigger ranked list);
                    # floor-or-above batches keep the fast path
                    t_rank = min([self.t_floor]
                                 + [it[3] for it in g_items])
                    if t_rank < self.t_floor:
                        self._count("subfloor_batches")
                    inflight.append((g_items, qbytes, errors, pd,
                                     t_rank))
                del hashed_group, metas, pendings, s
            except Exception as e:  # a resident server must survive
                for g_items in groups:
                    self._fail_batch(g_items, e)
                continue
            # keep two full groups dispatched ahead: the device then
            # never idles through the scorer's fetch+rank+dispatch
            # phase; sparse
            # traffic still drains immediately via the idle branch
            while len(inflight) > max(self.depth, 2 * len(groups)):
                self._emit_safe(inflight.popleft())
            _mark("t_drain", t0)
            self._slo_adjust()

    def _do_reload(self, req: _Reload):
        """Rebuild the index set and swap (scorer thread, window empty).

        Serving pauses for the load — queued requests wait, none drop —
        and the old index stays live if the rebuild fails.
        """
        try:
            self._bind_search(self._factory(req.paths))
        except Exception as e:
            self._count("failed_reloads")
            req.conn.send({"id": req.rid,
                           "error": f"reload failed: {e}"})
            return
        self._count("reloads")
        req.conn.send({"id": req.rid, "ok": True,
                       "documents": self._total_docs,
                       "indices": len(self.search.index_files)})

    def _fail_batch(self, items, exc):
        """Answer a batch whose scoring raised; the server lives on."""
        self._count("batch_failures")
        for conn, rid, *_ in items:
            conn.send({"id": rid, "error": f"internal error: {exc!r}"})

    def _emit_safe(self, entry):
        try:
            self._emit(*entry)
        except Exception as e:
            self._fail_batch(entry[0], e)

    def _emit(self, items, qbytes, errors, pending, t_rank=None):
        """Fetch + rank one batch at its rank threshold (the floor,
        or lower when the batch holds sub-floor requests), refine per
        request."""
        if t_rank is None:
            t_rank = self.t_floor
        # mixed-term-size federation in top-k mode: rank with the FULL
        # per-index candidate budget (n_indices * k). Capping the
        # merged list at k BEFORE the per-index threshold refinement
        # would drop entries of one index that outrank the cut on
        # their own floor (the embedded Search filters per index
        # first); _emit_ranked re-applies the k cap after refinement.
        rank_limit = self.limit
        if self.limit > 0 and self._uniform_ts is None:
            rank_limit = self.limit * len(self.search.index_files)
        self._emit_ranked(items, qbytes, self.search._finish_batch(
            qbytes, errors, pending, t_rank, rank_limit,
            self._total_docs), t_rank)

    def _emit_ranked(self, items, qbytes, ranked, t_rank=None):
        """Refine + send per item. Failures past this point answer
        ONLY their own item: a whole-batch retry would double-respond
        items already sent and desync the one-response-per-request
        protocol for every pipelined client on those connections."""
        now = time.monotonic()
        with self._lock:
            self._lat.extend((now - it[5]) * 1e3 for it in items)
            self._lat_count += len(items)
        if t_rank is None:
            t_rank = self.t_floor
        for (conn, rid, _q, thr, lim, _t0), qb, res in zip(
                items, qbytes, ranked):
            try:
                if isinstance(res, QueryError):
                    self._count("query_errors")
                    conn.send({"id": rid, "error": res.message})
                    continue
                if thr > t_rank:
                    if self._uniform_ts is not None:
                        # term count from the scored BYTES (len(str)
                        # diverges for non-ASCII text-mode queries)
                        num_terms = len(qb) - self._uniform_ts + 1
                        res = res.cut(
                            min_score=math.ceil(thr * num_terms))
                    else:
                        # mixed term sizes: one fraction -> a per-index
                        # score floor, applied by source index (exactly
                        # Search._finish_batch's per-index thresholds)
                        res = res.cut_per_index(
                            self._doc_bounds,
                            [math.ceil(thr * max(len(qb) - ts + 1, 0))
                             for ts in self._term_sizes])
                if lim > 0:
                    res = res.cut(limit=lim)
                conn.send(_LazyResult(rid, res, self._fmt))
            except Exception as e:
                self._count("batch_failures")
                conn.send({"id": rid,
                           "error": f"internal error: {e!r}"})
