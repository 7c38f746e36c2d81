"""Search API: thresholding, ranking, multi-index federation.

Mirrors the observable semantics of the reference `ClassicSearch`
(reference: cobs/query/classic_search.cpp:109-202, 403-505):

- per index threshold = ceil(threshold * (|q| - term_size_i + 1));
- results sorted by (score desc, doc index asc), multi-index ties by
  (index id, doc id) ascending;
- num_results == 0 means all documents;
- auto-detects classic vs compact files from the header.

Adds `search_batch` — many queries scored in one device launch, the main
throughput lever the serial reference lacks.
"""

import dataclasses
import math

import numpy as np

from cobs_tpu.query.engine import (
    DeviceIndex,
    QueryBytes,
    StreamedIndex,
    _pad_words,
    create_hashes,
    prepack_query_bytes,
    score_batch,
    score_batch_async,
    score_topk,
)
from cobs_tpu.settings import device_index_budget, settings
from cobs_tpu.utils.timer import Timer


def _device_bytes(path) -> int:
    """Device memory an index takes once loaded: its rows at the padded
    device row width (an upper bound for compact indexes, whose
    equal-size pages may coalesce into fewer padded rows)."""
    from cobs_tpu.fmt import classic as fmt_classic
    from cobs_tpu.fmt import compact as fmt_compact
    from cobs_tpu.fmt.magic import FileIOError

    if fmt_classic.is_classic_file(path):
        h = fmt_classic.read_classic_header(path)
        rows, row_bytes = h.signature_size, h.row_size
    elif fmt_compact.is_compact_file(path):
        h, _ = fmt_compact.read_compact_header(path)
        rows = sum(p.signature_size for p in h.parameters)
        row_bytes = h.page_size
    else:
        raise FileIOError(f'Could not open index path "{path}"')
    return (rows + 1) * _pad_words(-(-row_bytes // 4)) * 4


def _open_index(path, streamed):
    """Pick the backend for an index path, and with it where the index
    is scored:

    - DeviceIndex: the whole matrix resident in device memory; hashing
      (settings.device_hash), gather, AND, count and top-k run on the
      device.
    - StreamedIndex: the payload stays in a host mmap and only the rows
      a batch touches are read; under settings.streamed_host_score
      "auto" (the default) they are scored on the HOST CPU by the native
      kernel whenever it is available, so such an index never uses the
      device.

    streamed=True forces StreamedIndex; False forces DeviceIndex (the
    reference's --load-complete); None picks DeviceIndex when the index's
    device footprint fits settings.device_index_budget() (derived from
    the device's memory limit), else StreamedIndex (the reference's
    default mmap behavior).
    """
    if streamed is None:
        if settings.load_complete_index:
            streamed = False
        else:
            import os

            if not os.path.isfile(path):
                from cobs_tpu.fmt.magic import FileIOError

                raise FileIOError(
                    f'Could not open index path "{path}"') from None
            streamed = _device_bytes(path) > device_index_budget()
    return (StreamedIndex(path) if streamed
            else DeviceIndex.from_file(path))


class QueryError(Exception):
    """Per-query failure marker yielded by `search_stream`.

    The reference dies process-wide on an invalid query
    (reference: cobs/query/classic_search.cpp:66-107); a serving loop
    must not — one malformed query in a stream yields a QueryError in
    that query's slot while the rest of its batch scores normally.
    Truthiness is False so `if results:` skips it like an empty hit
    list.
    """

    def __init__(self, query, message: str):
        super().__init__(message)
        self.query = query
        self.message = message

    def __bool__(self):
        return False

    def __len__(self):
        return 0

    def __iter__(self):
        return iter(())

    def __repr__(self):
        return f"QueryError({self.message!r})"


@dataclasses.dataclass
class SearchResult:
    doc_name: str
    score: int

    def __iter__(self):
        return iter((self.doc_name, self.score))

    def __repr__(self):
        return f"SearchResult({self.doc_name!r}, {self.score})"


class ResultList:
    """Lazy ranked-result sequence (list[SearchResult] semantics).

    Ranking a 10k-document index yields the full document list per
    query when num_results == 0 (reference semantics); building the
    dataclass instances eagerly measured ~17 ms/query of host time —
    dominating the serving loop. The view keeps the sorted (doc, score)
    arrays and materializes SearchResult objects only on access, so
    `len(results)` / `results[0]` / slicing stay O(accessed), matching
    how results are actually consumed.
    """

    __slots__ = ("_names", "_gidx", "_scores")

    def __init__(self, names, gidx, scores):
        self._names = names
        self._gidx = gidx
        self._scores = scores

    def __len__(self):
        return len(self._gidx)

    def __bool__(self):
        return len(self._gidx) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            rng = range(*i.indices(len(self._gidx)))
            return [self[j] for j in rng]
        return SearchResult(self._names[self._gidx[i]],
                            int(self._scores[i]))

    def __iter__(self):
        names = self._names
        for g, s in zip(self._gidx.tolist(), self._scores.tolist()):
            yield SearchResult(names[g], s)

    def __eq__(self, other):
        if isinstance(other, (ResultList, list, tuple)):
            return (len(self) == len(other)
                    and all(a == b for a, b in zip(self, other)))
        return NotImplemented

    def __repr__(self):
        return repr(list(self))

    def pairs(self) -> list:
        """[[doc_name, score], ...] without per-doc SearchResult
        construction (the serving JSON shape; CLAUDE.md: eager per-doc
        objects once cost 73% of serving wall time)."""
        names = self._names
        return [[names[g], s] for g, s in
                zip(self._gidx.tolist(), self._scores.tolist())]

    def cut(self, min_score=None, limit=None) -> "ResultList":
        """Prefix-refine an already-ranked list (O(log n)).

        Scores are sorted descending with exact reference tie order, so
        both a HIGHER score floor and a SMALLER result cap are prefix
        cuts — the serving front-end ranks each batch once at the
        server's floor and refines per request (query/server.py).
        """
        n = len(self._gidx)
        if min_score is not None and n:
            n = int(np.searchsorted(-self._scores.astype(np.int64),
                                    -int(min_score), side="right"))
        if limit is not None:
            n = min(n, int(limit))
        return ResultList(self._names, self._gidx[:n], self._scores[:n])

    def serialize_with(self, formatter) -> bytes | None:
        """JSON fragment [["name",score],...] via a native
        ResultFormatter (the serving hot path — json.dumps of a k=100
        response costs ~40 us of GIL time; the native formatter ~7).
        None when the native runtime is unavailable."""
        return formatter(self._gidx, self._scores)

    def cut_per_index(self, doc_bounds, min_scores) -> "ResultList":
        """Refine with a PER-INDEX score floor (O(n) stable filter).

        A heterogeneous federation (mixed term sizes) turns one
        fractional threshold into a different minimum score per index
        — the same per-index `ceil(t * num_terms)` the embedded rank
        applies (Search._finish_batch) — so the refinement is a filter
        keyed by each result's source index, not a prefix cut.
        `doc_bounds` is the cumulative per-index document count (the
        global-doc-id upper bound of each index); order is preserved,
        so reference (score desc, doc asc) tie order survives.
        """
        if not len(self._gidx):
            return self
        idx_of = np.searchsorted(doc_bounds, self._gidx, side="right")
        keep = self._scores >= np.asarray(
            min_scores, dtype=np.int64)[idx_of]
        return ResultList(self._names, self._gidx[keep],
                          self._scores[keep])


class Search:
    """Query one or more device-resident indices.

    Accepts an index path (auto-detect classic/compact), a DeviceIndex, or
    a list of either (multi-index federation, reference:
    cobs/query/classic_search.cpp:413-435).
    """

    def __init__(self, indices, mesh=None, streamed=None):
        """mesh: optional jax.sharding.Mesh with ("batch", "docs") axes;
        when given, every index is document-sharded across the mesh and
        queries are scored with the shard_map engine (see
        cobs_tpu/parallel/sharded.py). Single-chip is the default.

        streamed: True = host-mmap backend (index larger than HBM),
        False = force full HBM residence, None = auto by size.
        """
        if not isinstance(indices, (list, tuple)):
            indices = [indices]
        self.index_files = [
            ix if isinstance(ix, (DeviceIndex, StreamedIndex))
            else _open_index(ix, streamed)
            for ix in indices]
        self._sharded = None
        if mesh is not None:
            from cobs_tpu.parallel.sharded import ShardedIndex
            # StreamedIndex inputs upload shard-by-shard: indexes larger
            # than one chip's HBM spread over the mesh's combined HBM
            self._sharded = [ShardedIndex(ix, mesh)
                             for ix in self.index_files]
        self.timer_ = Timer()

    def timer(self) -> Timer:
        return self.timer_

    def search(self, query, threshold: float = 0.0,
               num_results: int = 0) -> list[SearchResult]:
        return self.search_batch([query], threshold, num_results)[0]

    def _use_device_hash(self, ix, qbytes) -> bool:
        """Device-side hashing applies to device-resident matrices:
        plain DeviceIndex backends and mesh-sharded search (where the
        query-bytes broadcast also shrinks the interconnect traffic
        4x+). Streamed (host-scored) backends need host-side row ids,
        and the sequence-parallel split still hashes on the host."""
        if str(settings.device_hash).lower() not in (
                "auto", "device", "1", "true"):
            return False
        if self._sharded is not None:
            if self._sharded[0].mesh.shape["batch"] > 1:
                t_max = max(len(q) for q in qbytes) - ix.term_size + 1
                if t_max >= settings.seq_split_terms:
                    return False  # _dispatch_seq needs host hashes
            return True
        return isinstance(ix, DeviceIndex)

    def _prepack(self, ix, qb: QueryBytes) -> None:
        """Prepack the device-hash upload on the hashing thread (the
        one search_stream overlaps with the device) so dispatch only
        stacks+uploads. Mesh shards pack differently and skip it;
        COBS_TPU_PREPACK=0 is the A/B knob."""
        import os
        if self._sharded is None and os.environ.get(
                "COBS_TPU_PREPACK", "1") != "0":
            prepack_query_bytes(ix, qb)

    def _hash_batch(self, qbytes, timer=None) -> list:
        """Host stage: per-index hash tensors for a query batch —
        or a QueryBytes payload for device-hash-eligible indexes
        (hashing then happens inside the scoring program).

        `timer` lets worker threads time into a private Timer (merged
        by the caller) instead of racing the main thread's phases."""
        from cobs_tpu.ops.device_hash import validate_queries

        timer = self.timer_ if timer is None else timer
        max_term_size = max(ix.term_size for ix in self.index_files)
        for q in qbytes:
            if len(q) < max_term_size:
                raise ValueError(
                    f"query too short, needs to be at least "
                    f"{max_term_size} characters long")
        timer.active("hashes")
        hashed = []
        for ix in self.index_files:
            if self._use_device_hash(ix, qbytes):
                validate_queries(qbytes, ix.term_size, ix.canonicalize)
                qb = QueryBytes(qbytes)
                self._prepack(ix, qb)
                hashed.append(qb)
            else:
                hashed.append(create_hashes(
                    qbytes, ix.term_size, ix.num_hashes,
                    ix.canonicalize))
        timer.stop()
        return hashed

    def _hash_batch_lenient(self, qbytes, timer):
        """Like _hash_batch, but an invalid query flags its own slot
        instead of aborting the batch (serving-loop robustness; the
        reference's per-query die is classic_search.cpp:66-107).

        Returns (hashed, errors): errors[b] is None or the message;
        flagged slots carry a 1-term dummy hash so batch shapes stay
        static — their scores are discarded by the caller.
        """
        from cobs_tpu.ops.device_hash import validate_queries

        max_term_size = max(ix.term_size for ix in self.index_files)
        errors: list[str | None] = [None] * len(qbytes)
        timer.active("hashes")
        hashed = []
        for ix in self.index_files:
            if self._use_device_hash(ix, qbytes):
                # batch fast path: uniform length, nothing flagged yet,
                # every byte valid -> one vectorized check for the
                # whole batch (the serving common case)
                from cobs_tpu.ops.device_hash import invalid_query_mask

                L0 = len(qbytes[0]) if qbytes else 0
                if (qbytes and L0 >= max_term_size
                        and all(e is None for e in errors)
                        and all(len(q) == L0 for q in qbytes)):
                    arr = np.frombuffer(b"".join(qbytes),
                                        np.uint8).reshape(len(qbytes),
                                                          L0)
                    if not invalid_query_mask(arr,
                                              ix.canonicalize).any():
                        qb = QueryBytes(list(qbytes))
                        self._prepack(ix, qb)
                        hashed.append(qb)
                        continue
                # same per-query leniency: a bad query's slot carries a
                # valid 1-term dummy (scores discarded by the caller)
                cleaned = []
                for b, q in enumerate(qbytes):
                    if errors[b] is None:
                        if len(q) < max_term_size:
                            errors[b] = (
                                f"query too short, needs to be at "
                                f"least {max_term_size} characters "
                                "long")
                        else:
                            try:
                                validate_queries([q], ix.term_size,
                                                 ix.canonicalize)
                            except ValueError as e:
                                errors[b] = str(e)
                    cleaned.append(q if errors[b] is None
                                   else b"A" * ix.term_size)
                qb = QueryBytes(cleaned)
                self._prepack(ix, qb)
                hashed.append(qb)
                continue
            dummy = np.zeros((1, ix.num_hashes), dtype=np.uint64)
            per_q = []
            for b, q in enumerate(qbytes):
                if errors[b] is not None:
                    per_q.append(dummy)
                    continue
                if len(q) < max_term_size:
                    errors[b] = (f"query too short, needs to be at "
                                 f"least {max_term_size} characters "
                                 "long")
                    per_q.append(dummy)
                    continue
                try:
                    per_q.append(create_hashes(
                        [q], ix.term_size, ix.num_hashes,
                        ix.canonicalize)[0])
                except ValueError as e:
                    errors[b] = str(e)
                    per_q.append(dummy)
            hashed.append(per_q)
        timer.stop()
        return hashed, errors

    def search_batch(self, queries, threshold: float = 0.0,
                     num_results: int = 0) -> list[list[SearchResult]]:
        """Score a batch of queries in one device launch per index."""
        if not self.index_files or not queries:
            return [[] for _ in queries]
        qbytes = [q.encode() if isinstance(q, str) else bytes(q)
                  for q in queries]
        return self._score_ranked(qbytes, self._hash_batch(qbytes),
                                  threshold, num_results)

    def _score_ranked(self, qbytes, hashed, threshold,
                      num_results) -> list[list[SearchResult]]:
        """Device stage + ranking for a pre-hashed batch."""
        B = len(qbytes)
        if num_results > 0:
            # top-k fast path: only [B, k]-shaped (score, doc) pairs
            # cross the device-to-host link instead of full score
            # vectors ([B, shards*k] candidates when sharded)
            if self._sharded is not None:
                self.timer_.active("io")
                per_index = [sh.score_topk(hashed[k], num_results)
                             for k, sh in enumerate(self._sharded)]
                self.timer_.stop()
            else:
                per_index = [
                    ix.score_topk(hashed[k], num_results, self.timer_)
                    if isinstance(ix, StreamedIndex)
                    else score_topk(ix, hashed[k], num_results,
                                    self.timer_)
                    for k, ix in enumerate(self.index_files)]
            self.timer_.active("sort results")
            if len(self.index_files) == 1:
                v, d = per_index[0]
                out = self._rank_sparse_batch(
                    v[:B], d[:B], self._sparse_lims(qbytes, threshold),
                    num_results)
                self.timer_.stop()
                return out
            out = self._rank_sparse_multi(
                per_index, self._sparse_lims_multi(qbytes, threshold),
                num_results)
            self.timer_.stop()
            return out
        per_index_scores = []
        thresholds = []
        for k, ix in enumerate(self.index_files):
            hashes = hashed[k]
            if self._sharded is not None:
                self.timer_.active("io")
                per_index_scores.append(
                    self._sharded[k].score_batch(hashes))
                self.timer_.stop()
            elif isinstance(ix, StreamedIndex):
                per_index_scores.append(
                    ix.score_batch(hashes, self.timer_))
            else:
                per_index_scores.append(
                    score_batch(ix, hashes, self.timer_))
            thresholds.append([
                math.ceil(threshold * (len(q) - ix.term_size + 1))
                for q in qbytes])

        self.timer_.active("sort results")
        out: list[list[SearchResult]] = []
        total_docs = sum(len(ix.file_names) for ix in self.index_files)
        for b in range(B):
            limit = total_docs if num_results == 0 else min(
                num_results, total_docs)
            out.append(self._rank(
                [s[b] for s in per_index_scores],
                [t[b] for t in thresholds], limit))
        self.timer_.stop()
        return out

    def _dispatch_async(self, hashed, num_results):
        """Dispatch one pre-hashed batch without fetching: device work
        is enqueued ahead (HBM-resident backends) or handed to a host
        worker (streamed backends). Device fetches stay on the thread
        that calls `.fetch()`."""
        from cobs_tpu.query.engine import score_topk_async

        if self._sharded is not None:
            if num_results > 0:
                return [sh.score_topk_async(hashed[k], num_results)
                        for k, sh in enumerate(self._sharded)]
            return [sh.score_batch_async(hashed[k])
                    for k, sh in enumerate(self._sharded)]
        if num_results > 0:
            return [ix.score_topk_async(hashed[k], num_results,
                                        self.timer_)
                    if isinstance(ix, StreamedIndex)
                    else score_topk_async(ix, hashed[k],
                                          num_results, self.timer_)
                    for k, ix in enumerate(self.index_files)]
        return [ix.score_batch_async(hashed[k], self.timer_)
                if isinstance(ix, StreamedIndex)
                else score_batch_async(ix, hashed[k], self.timer_)
                for k, ix in enumerate(self.index_files)]

    def _mega_k(self) -> int:
        """Batches per device program when the queue is deep (1 = no
        mega-dispatch). >1 for HBM-resident backends — plain
        DeviceIndex and mesh-sharded (whose matrix is device-resident
        regardless of the input backend) — the regime where the fixed
        per-dispatch+fetch cost (not device work) bounds served
        throughput. Streamed backends score on the host (no dispatch
        cost to amortize)."""
        if self._sharded is None and not all(
                isinstance(ix, DeviceIndex) for ix in self.index_files):
            return 1
        return max(1, int(settings.mega_batches))

    def _mega_k_capped(self, batch_size: int, num_results: int) -> int:
        """_mega_k with the full-rank HBM budget applied: every
        in-flight full-rank group holds one [K, B, slots] u16 score
        buffer PER index (a federation multiplies the footprint), so
        the cap divides the budget by the SUM of per-index slot
        widths. Top-k groups ([K, B, k]) are never bound. The one
        formula serves both search_stream and QueryServer."""
        mega = self._mega_k()
        if mega > 1 and num_results == 0:
            slots = sum(ix.word_width * 32 * ix.num_pages
                        for ix in self.index_files)
            mega = max(1, min(mega, _MEGA_FULLRANK_BYTES
                              // max(1, slots * 2 * batch_size)))
        return mega

    def _dispatch_multi_async(self, hashed_group, num_results):
        """Mega-dispatch: K pre-hashed batches as ONE device program
        per index (engine.score_*_multi_async). Returns one pending
        list per batch — the exact per-batch contract of
        `_dispatch_async`, so `_finish_batch` consumes them unchanged."""
        from cobs_tpu.query.engine import (
            score_batch_multi_async,
            score_topk_multi_async,
        )

        K = len(hashed_group)
        per_index = []
        for kx, ix in enumerate(self.index_files):
            payloads = [hashed_group[g][kx] for g in range(K)]
            if self._sharded is not None:
                sh = self._sharded[kx]
                self.timer_.active("io")
                per_index.append(
                    sh.score_topk_multi_async(payloads, num_results)
                    if num_results > 0
                    else sh.score_batch_multi_async(payloads))
                self.timer_.stop()
            elif num_results > 0:
                per_index.append(score_topk_multi_async(
                    ix, payloads, num_results, self.timer_))
            else:
                per_index.append(score_batch_multi_async(
                    ix, payloads, self.timer_))
        return [[pi[g] for pi in per_index] for g in range(K)]

    def _dispatch_group_async(self, hashed_group, num_results):
        """Dispatch a group of pre-hashed batches, packing
        power-of-two runs into single device programs. Power-of-two
        bucketing bounds the set of compiled K variants to
        log2(mega_batches); a group of 7 dispatches as 4 + 2 + 1."""
        out, i, K = [], 0, len(hashed_group)
        while i < K:
            n = 1 << ((K - i).bit_length() - 1)
            if n == 1:
                out.append(self._dispatch_async(hashed_group[i],
                                                num_results))
            else:
                out.extend(self._dispatch_multi_async(
                    hashed_group[i:i + n], num_results))
            i += n
        return out

    def _finish_batch(self, qbytes, errors, pending, threshold,
                      num_results, total_docs):
        """Fetch + rank one dispatched batch (pairs `_dispatch_async`).

        Returns one ResultList (or QueryError) per query, reference
        ordering (score desc, doc asc)."""
        self.timer_.active("add rows")
        lims = lims_multi = None
        if num_results > 0:
            # compute the score floors BEFORE fetching: pending device
            # top-k handles use them to read only the narrow tier
            # prefix (engine.PendingTopK.fetch_topk) — the same floors
            # then drive the ranking, so tier sufficiency and the
            # ranked prefix can never disagree
            if len(self.index_files) == 1:
                lims = self._sparse_lims(qbytes, threshold)
                lims_multi = [lims]
            else:
                ml = self._sparse_lims_multi(qbytes, threshold)
                lims_multi = list(ml)
            # errored rows' results are discarded, so their floors must
            # not force a tier escalation (a too-short query's floor
            # computes to 0, which no valid score is ever below)
            err = np.asarray([e is not None for e in errors])
            tier_lims = lims_multi
            if err.any():
                tier_lims = [np.where(err[:len(lm)], np.int64(1) << 30,
                                      lm) for lm in lims_multi]
            # a floor of 0 can never fit the tier (valid docs score
            # >= 0): skip the prefix fetch rather than pay a wasted
            # round trip before the inevitable full fetch
            tier = settings.tier_fetch and all(
                lm.min() > 0 for lm in tier_lims if len(lm))
            fetched = [p.fetch_topk(tier_lims[k], num_results)
                       if tier and hasattr(p, "fetch_topk")
                       else p.fetch()
                       for k, p in enumerate(pending)]
        else:
            fetched = [p.fetch() for p in pending]
        self.timer_.active("sort results")
        out = []
        ranked = None
        if num_results > 0:
            if len(self.index_files) == 1:
                v, d = fetched[0]
                ranked = self._rank_sparse_batch(
                    v, d, lims, num_results)
            else:
                ranked = self._rank_sparse_multi(
                    fetched, np.stack(lims_multi), num_results)
        for b in range(len(qbytes)):
            if errors[b] is not None:
                out.append(QueryError(qbytes[b], errors[b]))
                continue
            if ranked is not None:
                out.append(ranked[b])
                continue
            thr = [math.ceil(threshold *
                             (len(qbytes[b]) - ix.term_size + 1))
                   for ix in self.index_files]
            out.append(self._rank(
                [s[b] for s in fetched], thr, total_docs))
        self.timer_.stop()
        return out

    def search_stream(self, queries, threshold: float = 0.0,
                      num_results: int = 0, batch_size: int = 64):
        """Stream ranked results for an iterable of queries.

        The production serving loop: queries are grouped into batches
        of `batch_size`; while the device scores and the main thread
        ranks batch k, a worker thread hashes batch k+1 (the native
        hashing kernels release the GIL, so this is real overlap).
        A bounded window of score batches is additionally kept in
        flight — dispatched-ahead device work for HBM-resident and
        mesh-sharded indexes, a host worker thread for streamed
        host-scored ones — so batch k's fetch overlaps batch k+1's
        scoring. This covers full ranking, top-k
        (num_results > 0), StreamedIndex, and mesh-sharded backends.

        DeviceIndex backends additionally pack groups of up to
        `settings.mega_batches` consecutive batches into ONE device
        program (mega-dispatch, engine.score_*_multi_async): K batches
        per program divide the fixed per-dispatch+fetch cost by K while
        the per-step batch size stays at batch_size.

        Yields one `list[SearchResult]` per query, in order. An
        invalid query (too short, non-ACGT) yields a `QueryError` in
        its slot instead of aborting the stream.
        """
        import collections
        import concurrent.futures
        import itertools

        it = iter(queries)
        DEPTH = 2   # bounded: each unfetched batch holds device buffers
        MEGA = self._mega_k_capped(batch_size, num_results)
        AHEAD = max(1, int(settings.hash_ahead))
        GROUPS = max(1, int(settings.dispatch_groups))
        total_docs = sum(len(ix.file_names) for ix in self.index_files)

        def hash_next():
            batch = list(itertools.islice(it, batch_size))
            if not batch:
                return None, None, None, None
            qbytes = [q.encode() if isinstance(q, str) else bytes(q)
                      for q in batch]
            # private timer: the worker must not race the main thread's
            # scoring phases on the shared Timer
            t = Timer()
            hashed, errors = self._hash_batch_lenient(qbytes, t)
            return qbytes, hashed, errors, t

        def finish(qbytes, errors, pending):
            return self._finish_batch(qbytes, errors, pending,
                                      threshold, num_results,
                                      total_docs)

        inflight = collections.deque()
        ready = []   # hashed batches awaiting a (mega-)dispatch

        def flush():
            pendings = self._dispatch_group_async(
                [h for _, h, _ in ready], num_results)
            for (qb, _, er), pd in zip(ready, pendings):
                inflight.append((qb, er, pd))
            ready.clear()

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            # the single worker executes queued hash_next calls FIFO,
            # so query order is preserved at any ahead depth; depth 1
            # hashes exactly one batch ahead, deeper keeps the worker
            # busy through the main thread's dispatch+fetch+rank
            hash_q = collections.deque(
                pool.submit(hash_next) for _ in range(AHEAD))
            while True:
                qbytes, hashed, errors, t = hash_q.popleft().result()
                if qbytes is None:
                    break
                self.timer_.merge(t)
                hash_q.append(pool.submit(hash_next))
                ready.append((qbytes, hashed, errors))
                if len(ready) >= MEGA:
                    flush()
                # window in batches: GROUPS mega groups ahead stay
                # dispatched while the previous drains, so the device
                # never idles through the host's fetch+rank+dispatch
                # phase (bounded, like DEPTH); MEGA == 1 reduces to the
                # plain DEPTH
                while len(inflight) > max(DEPTH, GROUPS * MEGA):
                    yield from finish(*inflight.popleft())
            if ready:
                flush()
            while inflight:
                yield from finish(*inflight.popleft())

    def _rank_sparse_multi(self, fetched, lims, num_results
                           ) -> list["ResultList"]:
        """Vectorized federation top-k ranking — the multi-index analog
        of `_rank_sparse_batch`, replacing a per-query `np.lexsort`
        (`_rank_sparse`, kept as the oracle) that cost ~15 us/query
        of host time.

        fetched: per-index (scores [B', k_i], docs [B', k_i]) device
        top-k pairs (B' >= B; padding slots carry score -1).
        lims: int64 [n_indices, B] per-index per-query score floors
        (>= 0). One composed-key argsort ranks the whole batch:
        (score << 40) - global_doc is unique per row (per-index doc ids
        are distinct, index ranges disjoint) and orders exactly by
        (score desc, doc asc); every excluded entry (score forced to
        -1, key >= 2^40) sorts after every kept one (key <= doc <
        2^40), so the per-query prefix cut is exact. Reference
        ordering contract: cobs/query/classic_search.cpp:140-144,
        166-201."""
        B = lims.shape[1]
        Vs, Gs = [], []
        base = 0
        for k, ix in enumerate(self.index_files):
            v, d = fetched[k]
            v = np.asarray(v)[:B].astype(np.int64)
            d = np.asarray(d)[:B].astype(np.int64)
            keep = v >= lims[k][:, None]   # lims >= 0 excludes padding
            Vs.append(np.where(keep, v, -1))
            Gs.append(d + base)
            base += len(ix.file_names)
        V = np.concatenate(Vs, axis=1)
        G = np.concatenate(Gs, axis=1)
        n = (V >= 0).sum(axis=1)
        if num_results:
            n = np.minimum(n, num_results)
        names = self._names
        if V.size and (int(V.max()) >= 1 << 23 or base >= 1 << 40):
            # composed key would overflow (8M+-term queries or 1T+
            # docs); exact 2-key path for that regime
            out = []
            for b in range(B):
                order = np.lexsort((G[b], -V[b]))[:n[b]]
                out.append(ResultList(names, G[b][order], V[b][order]))
            return out
        order = np.argsort(G - (V << 40), axis=1)
        V = np.take_along_axis(V, order, axis=1)
        G = np.take_along_axis(G, order, axis=1)
        return [ResultList(names, G[b, :n[b]], V[b, :n[b]])
                for b in range(B)]

    def _sparse_lims_multi(self, qbytes, threshold) -> np.ndarray:
        """Per-index per-query score floors, int64 [n_indices, B]."""
        return np.array(
            [[max(0, math.ceil(threshold *
                               (len(qb) - ix.term_size + 1)))
              for qb in qbytes] for ix in self.index_files],
            dtype=np.int64)

    def _rank_sparse(self, topk_list, thresholds, num_results
                     ) -> list[SearchResult]:
        """Ranking from per-index device top-k (score, doc) pairs.

        Per-query reference path — superseded in production by the
        vectorized `_rank_sparse_multi`, kept as its test oracle."""
        names = self._names
        kept_scores, kept_global = [], []
        order_base = 0
        for k, ix in enumerate(self.index_files):
            v, d = topk_list[k]
            m = (v >= max(0, thresholds[k])) & (v >= 0)
            kept_scores.append(v[m].astype(np.int64))
            kept_global.append(d[m] + order_base)
            order_base += len(ix.file_names)
        scores = np.concatenate(kept_scores)
        gidx = np.concatenate(kept_global)
        num_results = min(num_results, scores.size)
        order = np.lexsort((gidx, -scores))[:num_results] \
            if scores.size else np.empty(0, dtype=np.int64)
        return ResultList(names, gidx[order], scores[order])

    def _rank_sparse_batch(self, v, d, lims, num_results):
        """Vectorized single-index top-k ranking.

        `lax.top_k` rows are already in the reference result order —
        score descending with ties preferring the lower slot, and slot
        numbering is monotone in document number (engine.score_topk) —
        so per-query ranking is a PREFIX LENGTH (entries >= the query's
        score floor; the -1 padding sorts last and is excluded by
        lims >= 0), not a sort. Replaces a per-query lexsort that
        cost ~15 us/query of host time.
        """
        n = (v >= lims[:, None]).sum(axis=1)
        if num_results:
            n = np.minimum(n, num_results)
        names = self._names
        return [ResultList(names, d[b, :n[b]],
                           v[b, :n[b]].astype(np.int64))
                for b in range(v.shape[0])]

    def _sparse_lims(self, qbytes, threshold) -> np.ndarray:
        ts = self.index_files[0].term_size
        return np.fromiter(
            (max(0, math.ceil(threshold * (len(qb) - ts + 1)))
             for qb in qbytes), np.int64, len(qbytes))

    @property
    def _names(self) -> list[str]:
        names = getattr(self, "_names_cache", None)
        if names is None:
            names = []
            for ix in self.index_files:
                names.extend(ix.file_names)
            self._names_cache = names
        return names

    def _rank(self, scores_list, thresholds, num_results
              ) -> list[SearchResult]:
        """Threshold + exact reference tie ordering."""
        names = self._names
        kept_scores: list[np.ndarray] = []
        kept_global: list[np.ndarray] = []
        order_base = 0
        for k, ix in enumerate(self.index_files):
            n = len(ix.file_names)
            s = scores_list[k][:n]
            mask = s >= thresholds[k]
            idx = np.nonzero(mask)[0]
            kept_scores.append(s[idx])
            # global tie key: (index id, doc id) ascending
            kept_global.append(idx + order_base)
            order_base += n
        scores = np.concatenate(kept_scores) if kept_scores else \
            np.empty(0, dtype=np.int64)
        gidx = np.concatenate(kept_global) if kept_global else \
            np.empty(0, dtype=np.int64)

        num_results = min(num_results, scores.size)
        if scores.size:
            # gidx is ascending by construction (per-index doc ids +
            # increasing order_base), so a STABLE sort on score alone
            # breaks ties by position = (index id, doc id) asc — the
            # reference tie order. Negated scores fit int16 whenever
            # the query has < 32768 terms, which selects NumPy's radix
            # path: measured 5.4x over the 2-key lexsort at 10k docs
            # (the full-ranking serving bottleneck once scoring was
            # vectorized).
            if int(scores.max()) < 32768:
                order = np.argsort((-scores).astype(np.int16),
                                   kind="stable")
            else:
                order = np.lexsort((gidx, -scores.astype(np.int64)))
            order = order[:num_results]
        else:
            order = np.empty(0, dtype=np.int64)
        return ResultList(names, gidx[order],
                          scores[order].astype(np.int64))


#: per-group device-buffer budget for FULL-RANK mega-dispatch (the
#: [K, B, slots] u16 scores live in HBM until fetched; the stream keeps
#: up to 2 groups + the current one in flight). Tuned on the previous
#: accelerator; not yet swept on the H100 (ROADMAP 1.3).
_MEGA_FULLRANK_BYTES = 256 << 20


#: alias matching the reference class name
ClassicSearch = Search
