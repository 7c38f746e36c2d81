"""Multi-chip sharding of the bit-sliced signature index.

The reference is single-node: its only parallelism is a pthread pool over
document-score batches (reference: cobs/util/parallel_for.hpp:24-63,
cobs/query/classic_search.cpp:355-400). This build introduces the
distributed layer itself, following the natural axes of the problem:

- **"docs" axis (tensor-parallel analog)**: the signature matrix
  ``[rows, W]`` (W = packed uint32 words, 32 documents per word) is
  sharded on the word axis. Each chip holds the full row range for a
  contiguous slice of documents, so the per-term row gather, the AND
  across hash functions and the popcount-accumulate are all **local** —
  no collective in the hot loop. Scores come back sharded on the same
  axis; assembling the final vector is one all-gather of ``[B, docs]``
  int32, tiny next to the matrix traffic.
- **"batch" axis (data-parallel analog)**: independent queries are
  sharded across chips; each chip scores its slice of the query batch
  against its matrix shard.

Construction is a functional scatter step on the same layout: bit-set
updates ``(row, doc)`` are broadcast, each shard applies the updates that
fall into its document range (mask + local scatter). Scatter-set into a
one-hot plane is idempotent, so duplicate (row, doc) pairs — frequent,
since documents repeat k-mers — need no dedup pass.

Single-chip is the 1x1 mesh special case of the same code path.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cobs_tpu.query.engine import (DeviceIndex, _gather_count_planes,
                                   _shrink_scores)


@functools.lru_cache(maxsize=None)
def _replicator(mesh: Mesh, ndim: int):
    """Jitted identity that reshards to fully-replicated — required
    before a host fetch when the mesh spans processes (shards on other
    hosts are not locally addressable)."""
    spec = P(*([None] * ndim))
    return jax.jit(lambda x: x,
                   out_shardings=NamedSharding(mesh, spec))


def _fetch(mesh: Mesh, arr: jax.Array) -> np.ndarray:
    """Device-to-host fetch that works on multi-process meshes."""
    if not arr.is_fully_addressable:
        arr = _replicator(mesh, arr.ndim)(arr)
    return np.asarray(jax.block_until_ready(arr))


def make_mesh(n_batch: int = 1, n_docs: int | None = None,
              devices=None) -> Mesh:
    """A ("batch", "docs") device mesh.

    Defaults to all available devices on the docs axis: document count
    scales with corpus size (the axis that outgrows one chip's HBM),
    while query batches can be regrown at will.
    """
    if devices is None:
        devices = jax.devices()
    if n_docs is None:
        n_docs = len(devices) // n_batch
    if n_batch * n_docs > len(devices):
        raise ValueError(
            f"mesh needs {n_batch * n_docs} devices, only "
            f"{len(devices)} available")
    if n_batch * n_docs != len(devices):
        devices = devices[: n_batch * n_docs]
    dev_array = np.asarray(devices).reshape(n_batch, n_docs)
    return Mesh(dev_array, axis_names=("batch", "docs"))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class PendingSharded:
    """A dispatched sharded scoring batch; `fetch()` materializes on
    the host. Keep the in-flight window bounded (the engine's
    PendingScores discipline): XLA has already enqueued the shard_map
    program, so fetch is the only blocking step."""

    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def fetch(self):
        return self._finish()


class ShardedIndex:
    """An index re-laid-out across a ("batch", "docs") mesh.

    Accepts a DeviceIndex (HBM-resident, re-sharded) or a StreamedIndex
    (host/disk-resident): in the streamed case each chip's word-column
    slice is read from the memory-mapped payload and uploaded directly
    to that chip, so an index **larger than one chip's HBM** becomes
    queryable as long as it fits the mesh's combined HBM.

    The word axis is padded so every "docs" shard gets an equal,
    `word_align`-aligned slice (128 words, the engine's _WORD_ALIGN,
    tuned on the previous accelerator and not yet swept on the H100,
    ROADMAP 1.3); padding words read as zero and the corresponding
    phantom documents are stripped when scores are assembled (the same
    discipline the compact file format uses for its last page,
    reference: cobs/construction/compact_index.cpp:137-150).
    """

    def __init__(self, index, mesh: Mesh, word_align: int = 128):
        self.mesh = mesh
        self.index = index
        n_docs = mesh.shape["docs"]
        W = index.word_width
        align = max(1, word_align) * n_docs
        self.word_width = _round_up(W, align)
        sharding = NamedSharding(mesh, P(None, "docs"))
        if hasattr(index, "matrix"):          # DeviceIndex
            host = np.asarray(index.matrix)   # [total_rows+1, W] u32
            if self.word_width != W:
                host = np.pad(host, ((0, 0), (0, self.word_width - W)))
            # compact pages are already stacked row-wise at uniform
            # width by DeviceIndex, so one word-axis shard spec covers
            # classic (P=1) and compact (P>1) alike; per-page rows stay
            # addressed through index.row_offsets.
            self.matrix = jax.device_put(host, sharding)
        else:                                 # StreamedIndex
            self.matrix = _upload_streamed_sharded(
                index, sharding, self.word_width)
        self._topk_mask = None

    @property
    def zero_row(self) -> int:
        return self.matrix.shape[0] - 1

    def _rows_idx(self, hashes_list, b_pad=None,
                  t_pad=None) -> np.ndarray:
        from cobs_tpu.query.engine import _bucket  # late: avoid cycle
        ix = self.index
        n_batch = self.mesh.shape["batch"]
        B_pad = (_round_up(max(len(hashes_list), n_batch), n_batch)
                 if b_pad is None else b_pad)
        T_max = (_bucket(max(h.shape[0] for h in hashes_list))
                 if t_pad is None else t_pad)
        rows_idx = np.full((B_pad, T_max, ix.num_hashes, ix.num_pages),
                           self.zero_row, dtype=np.int32)
        for b, hs in enumerate(hashes_list):
            rows_idx[b, :hs.shape[0]] = ix.row_indices(hs)
        return rows_idx

    def _pack_queries(self, queries, b_pad=None, t_pad=None):
        """Pad raw query bytes to mesh-divisible [B_pad, L_pad] u8 +
        true lengths (the device-hash analog of _rows_idx; the batch
        axis rounds to the mesh's "batch" size instead of the
        single-chip jit bucket)."""
        from cobs_tpu.query.engine import _pack_query_bytes
        n_batch = self.mesh.shape["batch"]
        if b_pad is None:
            b_pad = _round_up(max(len(queries), n_batch), n_batch)
        qb, lens, _ = _pack_query_bytes(queries, self.index.term_size,
                                        b_pad=b_pad, t_pad=t_pad)
        return qb, lens

    def _hash_args(self):
        ix = self.index
        if self.matrix.shape[0] > np.iinfo(np.int32).max:
            raise ValueError("index too large for int32 row addressing")
        return (ix.term_size, ix.num_hashes, ix.canonicalize,
                tuple(int(s) for s in ix.sig_sizes),
                tuple(int(o) for o in ix.row_offsets))

    def score_batch(self, hashes_list) -> np.ndarray:
        """Score a batch of queries (uint64 [T, h] raw hashes each, or
        an engine.QueryBytes payload for device-side hashing)
        across the mesh; returns int32 [B, counts_size] exactly like the
        single-chip ``engine.score_batch``.

        Very long queries (terms >= settings.seq_split_terms) switch to
        sequence parallelism: the term axis is split across the "batch"
        mesh axis and per-document scores merge with one psum
        (SURVEY §5's long-context mapping — no quadratic interaction
        exists, so a plain term shard + score reduction suffices)."""
        return self.score_batch_async(hashes_list).fetch()

    def score_batch_async(self, hashes_list) -> "PendingSharded":
        """Dispatch `score_batch` without fetching; `.fetch()`
        materializes. Bounded in-flight use only (the dispatch-ahead
        discipline of engine.PendingScores applies)."""
        from cobs_tpu.query.engine import QueryBytes

        if isinstance(hashes_list, QueryBytes):
            queries = hashes_list.queries
            qb, lens = self._pack_queries(queries)
            with jax.enable_x64():
                scores = score_sharded_from_queries(
                    self.mesh, self.matrix, jnp.asarray(qb),
                    jnp.asarray(lens), *self._hash_args())
            return PendingSharded(lambda: assemble_scores(
                _fetch(self.mesh, scores),
                self.index.doc_layout)[:len(queries)])

        B = len(hashes_list)
        if self._seq_split(hashes_list):
            scores = self._dispatch_seq(hashes_list)
        else:
            rows_idx = self._rows_idx(hashes_list)
            scores = score_sharded(self.mesh, self.matrix,
                                   jnp.asarray(rows_idx),
                                   self.index.num_hashes)
        return PendingSharded(lambda: assemble_scores(
            _fetch(self.mesh, scores),
            self.index.doc_layout)[:B])

    def _group_shapes(self, payloads):
        """Common (b_pad, t_pad) so K batches stack into one tensor
        (one compiled program per group shape)."""
        from cobs_tpu.query.engine import QueryBytes, _bucket
        n_batch = self.mesh.shape["batch"]
        b_pad = _round_up(max(max(len(p) for p in payloads), n_batch),
                          n_batch)
        if isinstance(payloads[0], QueryBytes):
            k = self.index.term_size
            t_pad = _bucket(max(len(q) for p in payloads
                                for q in p.queries) - k + 1)
        else:
            t_pad = _bucket(max(h.shape[0] for p in payloads
                                for h in p))
        return b_pad, t_pad

    def score_batch_multi_async(self, payloads) -> list:
        """Mega-dispatch over the mesh: K batches in ONE shard_map
        program (lax.scan inside the per-shard local, so the hot loop
        stays collective-free). One PendingSharded per batch; the first
        fetch materializes the whole group (engine._SharedFetch
        discipline). Falls back to per-batch dispatch when the group is
        sequence-parallel-eligible (seq split reshapes the mesh axes
        per batch)."""
        from cobs_tpu.query.engine import QueryBytes

        if len(payloads) == 1 or any(self._seq_split(p)
                                     for p in payloads):
            return [self.score_batch_async(p) for p in payloads]
        b_pad, t_pad = self._group_shapes(payloads)
        if isinstance(payloads[0], QueryBytes):
            L_pad = t_pad + self.index.term_size - 1
            qbs, lens = [], []
            for p in payloads:
                qb, ln = self._pack_queries(p.queries, b_pad=b_pad,
                                            t_pad=t_pad)
                assert qb.shape[1] == L_pad
                qbs.append(qb)
                lens.append(ln)
            with jax.enable_x64():
                scores = score_sharded_from_queries_multi(
                    self.mesh, self.matrix,
                    jnp.asarray(np.stack(qbs)),
                    jnp.asarray(np.stack(lens)), *self._hash_args())
        else:
            rows = np.stack([self._rows_idx(p, b_pad, t_pad)
                             for p in payloads])
            scores = score_sharded_multi(self.mesh, self.matrix,
                                         jnp.asarray(rows),
                                         self.index.num_hashes)
        shared = _SharedMeshFetch(self.mesh, scores)

        def finish_for(g, B):
            return lambda: assemble_scores(
                shared.get()[0][g], self.index.doc_layout)[:B]

        return [PendingSharded(finish_for(g, len(p)))
                for g, p in enumerate(payloads)]

    def score_topk_multi_async(self, payloads, k: int) -> list:
        """Mega-dispatch top-k over the mesh (see
        score_batch_multi_async); per-batch fetches share one
        materialization and merge per-shard candidates on the host."""
        from cobs_tpu.query.engine import QueryBytes, _doc_valid_mask

        if len(payloads) == 1 or any(self._seq_split(p)
                                     for p in payloads):
            return [self.score_topk_async(p, k) for p in payloads]
        ix = self.index
        if self._topk_mask is None:
            mask = _doc_valid_mask(
                ix.doc_layout.with_w32(self.word_width * 32),
                len(ix.file_names))
            mask = mask.reshape(ix.num_pages, self.word_width, 32)
            self._topk_mask = jax.device_put(
                mask, NamedSharding(self.mesh, P(None, "docs", None)))
        W32 = self.word_width * 32
        k_eff = min(k, W32 // self.mesh.shape["docs"] * ix.num_pages)
        b_pad, t_pad = self._group_shapes(payloads)
        if isinstance(payloads[0], QueryBytes):
            qbs, lens = [], []
            for p in payloads:
                qb, ln = self._pack_queries(p.queries, b_pad=b_pad,
                                            t_pad=t_pad)
                qbs.append(qb)
                lens.append(ln)
            with jax.enable_x64():
                vals, gidx = _topk_sharded_from_queries_multi(
                    self.mesh, self.matrix,
                    jnp.asarray(np.stack(qbs)),
                    jnp.asarray(np.stack(lens)), self._topk_mask,
                    *self._hash_args(), k_eff)
        else:
            rows = np.stack([self._rows_idx(p, b_pad, t_pad)
                             for p in payloads])
            vals, gidx = _topk_sharded_multi(
                self.mesh, self.matrix, jnp.asarray(rows),
                self._topk_mask, ix.num_hashes, k_eff)
        shared = _SharedMeshFetch(self.mesh, vals, gidx)

        def finish_for(g, B):
            def finish():
                v, gi = shared.get()
                return _merge_topk_host(v[g], gi[g], W32,
                                        ix.doc_layout, B, k)
            return finish

        return [PendingSharded(finish_for(g, len(p)))
                for g, p in enumerate(payloads)]

    def _rows_idx_seq(self, hashes_list) -> np.ndarray:
        """Row ids for the sequence-parallel paths: [B, T_pad, h, P]
        with the TERM axis padded to a multiple of the "batch" mesh
        axis (padding terms hit the zero row); the batch axis stays
        unpadded — it is replicated, not sharded, under seq split."""
        ix = self.index
        n_batch = self.mesh.shape["batch"]
        B = len(hashes_list)
        T_max = max(h.shape[0] for h in hashes_list)
        T_pad = _round_up(T_max, n_batch)
        rows_idx = np.full((B, T_pad, ix.num_hashes, ix.num_pages),
                           self.zero_row, dtype=np.int32)
        for b, hs in enumerate(hashes_list):
            rows_idx[b, :hs.shape[0]] = ix.row_indices(hs)
        return rows_idx

    def _dispatch_seq(self, hashes_list) -> jax.Array:
        """Sequence-parallel scoring: pad the term axis to a multiple
        of the "batch" axis (padding terms hit the zero row), shard it,
        psum-merge the partial counts."""
        return score_seq_sharded(self.mesh, self.matrix,
                                 jnp.asarray(
                                     self._rows_idx_seq(hashes_list)),
                                 self.index.num_hashes)

    def _seq_split(self, hashes_list) -> bool:
        """True when this (host-hashed) batch should run sequence-
        parallel: a >1 "batch" axis would otherwise idle on a long
        query padded to the batch grid."""
        from cobs_tpu.query.engine import QueryBytes
        from cobs_tpu.settings import settings

        if isinstance(hashes_list, QueryBytes):
            return False
        return (self.mesh.shape["batch"] > 1
                and max(h.shape[0] for h in hashes_list)
                >= settings.seq_split_terms)

    def score_topk(self, hashes_list, k: int):
        """Sharded top-k: each "docs" shard ranks its own documents with
        lax.top_k (a document's full score is shard-local, so per-shard
        winners cover the global top-k); only [B, shards*k] candidate
        pairs leave the device, merged on the host with the reference's
        (score desc, doc asc) tie order (reference:
        cobs/query/classic_search.cpp:140-144).

        Returns (scores i32 [B, k], doc_numbers i64 [B, k]) in the same
        score-slot numbering as engine.score_topk; padding slots carry
        score -1 and must be dropped by the caller.
        """
        return self.score_topk_async(hashes_list, k).fetch()

    def score_topk_async(self, hashes_list, k: int) -> "PendingSharded":
        """Dispatch `score_topk` without fetching; `.fetch()` merges
        the per-shard candidates on the host."""
        from cobs_tpu.query.engine import QueryBytes, _doc_valid_mask
        ix = self.index
        B = len(hashes_list)
        seq = self._seq_split(hashes_list)
        if not isinstance(hashes_list, QueryBytes):
            rows_idx = (self._rows_idx_seq(hashes_list) if seq
                        else self._rows_idx(hashes_list))
        if self._topk_mask is None:
            mask = _doc_valid_mask(
                ix.doc_layout.with_w32(self.word_width * 32),
                len(ix.file_names))
            mask = mask.reshape(ix.num_pages, self.word_width, 32)
            self._topk_mask = jax.device_put(
                mask, NamedSharding(self.mesh, P(None, "docs", None)))
        W32 = self.word_width * 32
        k_eff = min(k, W32 // self.mesh.shape["docs"] * ix.num_pages)
        if isinstance(hashes_list, QueryBytes):
            qb, lens = self._pack_queries(hashes_list.queries)
            with jax.enable_x64():
                vals, gidx = _topk_sharded_from_queries(
                    self.mesh, self.matrix, jnp.asarray(qb),
                    jnp.asarray(lens), self._topk_mask,
                    *self._hash_args(), k_eff)
        elif seq:
            # sequence-parallel top-k: term axis sharded over "batch",
            # partial counts psum-merged, then the same per-"docs"-
            # shard top-k — a long query with num_results > 0 uses the
            # whole mesh instead of idling (n_batch-1)/n_batch of it
            vals, gidx = _topk_seq_sharded(self.mesh, self.matrix,
                                           jnp.asarray(rows_idx),
                                           self._topk_mask,
                                           ix.num_hashes, k_eff)
        else:
            vals, gidx = _topk_sharded(self.mesh, self.matrix,
                                       jnp.asarray(rows_idx),
                                       self._topk_mask, ix.num_hashes,
                                       k_eff)

        def finish():
            return _merge_topk_host(_fetch(self.mesh, vals),
                                    _fetch(self.mesh, gidx), W32,
                                    ix.doc_layout, B, k)

        return PendingSharded(finish)


class _SharedMeshFetch:
    """One replicate-and-materialize shared by a mega-group's pending
    handles (the mesh analog of engine._SharedFetch)."""

    __slots__ = ("_mesh", "_dev", "_host")

    def __init__(self, mesh, *dev):
        self._mesh = mesh
        self._dev = dev
        self._host = None

    def get(self) -> tuple:
        if self._host is None:
            self._host = tuple(_fetch(self._mesh, a) for a in self._dev)
            self._dev = None
        return self._host


def _merge_topk_host(v, g, W32: int, lay, B: int, k: int):
    """Merge one batch's per-shard top-k candidates [B_pad, shards*k]
    into the engine.score_topk contract: (scores i32 [B, k'],
    doc_numbers i64 [B, k']), reference (score desc, doc asc) order.

    Vectorized over the batch with one composed-key argsort: documents
    partition across shards, so doc numbers are unique per row and the
    int64 key (score << 40) - doc orders exactly by (score desc, doc
    asc) with no stability requirement. Replaces a per-query
    np.lexsort that cost ~0.5 s of host time per 32k queries."""
    v = v[:B].astype(np.int64)
    g = g[:B]
    kk = min(k, v.shape[1])
    page, local = g.astype(np.int64) // W32, g.astype(np.int64) % W32
    dpp = lay.uniform_docs
    doc = (page * dpp + local if dpp is not None
           else lay.doc_offsets[page] + local)
    if v.size and (int(v.max()) >= 1 << 23 or int(doc.max()) >= 1 << 40):
        # composed key would overflow (queries beyond 8M terms or >1T
        # doc slots); keep the exact 2-key path for that regime
        out_v = np.empty((B, kk), dtype=np.int32)
        out_d = np.empty((B, kk), dtype=np.int64)
        for b in range(B):
            order = np.lexsort((doc[b], -v[b]))[:kk]
            out_v[b] = v[b][order]
            out_d[b] = doc[b][order]
        return out_v, out_d
    # keys are unique per row (docs partition across shards), so an
    # unstable sort is exact; selecting the k winners first
    # (argpartition, O(S)) and sorting only those measured 2.7x over
    # the full row argsort at [1024, 800] -> 100
    key = doc - (v << 40)
    if kk < key.shape[1]:
        part = np.argpartition(key, kk - 1, axis=1)[:, :kk]
        pkey = np.take_along_axis(key, part, axis=1)
        order = np.take_along_axis(part, np.argsort(pkey, axis=1),
                                   axis=1)
    else:
        order = np.argsort(key, axis=1)
    out_v = np.take_along_axis(v, order, axis=1).astype(np.int32)
    out_d = np.take_along_axis(doc, order, axis=1)
    return out_v, out_d


def score_sharded(mesh: Mesh, matrix: jax.Array, rows_idx: jax.Array,
                  num_hashes: int) -> jax.Array:
    """Sharded gather-AND-count.

    Args:
      matrix: u32 [total_rows+1, W] sharded P(None, "docs"); compact
        pages stacked row-wise (classic = 1 page); last row all-zero.
      rows_idx: i32 [B, T, h, pages] sharded P("batch", None, None,
        None); padding terms point at the zero row.
    Returns:
      i32 [B, pages, W, 32] scores sharded P("batch", None, "docs",
      None); page-local document d's score is at [b, p, d // 32, d % 32].
    """

    def local(mat, idx):
        # the engine's chunked packed-CSA formulation on the local
        # shard: same gather/count overlap and memory bound as
        # single-chip (see engine._gather_count_planes); the fetch
        # narrows to u16 exactly like the single-chip transfer
        # (engine._shrink_scores — scores are bounded by the term pad)
        return _shrink_scores(
            _gather_count_planes(mat, idx, num_hashes), idx.shape[1])

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P("batch", None, None, None)),
        out_specs=P("batch", None, "docs", None))(matrix, rows_idx)


def score_sharded_from_queries(mesh: Mesh, matrix: jax.Array, qbytes,
                               qlens, term_size: int, num_hashes: int,
                               canonicalize: int, sig_sizes: tuple,
                               row_offsets: tuple) -> jax.Array:
    """Sharded scoring with DEVICE-SIDE hashing (ops/device_hash).

    Each "batch" shard receives its slice of raw query bytes (~1 KB
    per query crossing the interconnect instead of 4 bytes per
    (term, hash, page) of row indices — the broadcast shrinks 4x+) and
    computes windows/canonicalization/XXH64/per-page-mod locally; the
    gather-AND-count is the same shard-local hot loop as
    score_sharded. Call under jax.enable_x64() (XXH64 needs emulated
    uint64)."""
    from cobs_tpu.ops.device_hash import rows_from_queries

    zero_row = matrix.shape[0] - 1

    def local(mat, qb, ql):
        rows = rows_from_queries(qb, ql, term_size, num_hashes,
                                 canonicalize, sig_sizes, row_offsets,
                                 zero_row)
        return _shrink_scores(
            _gather_count_planes(mat, rows, num_hashes), rows.shape[1])

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P("batch", None), P("batch")),
        out_specs=P("batch", None, "docs", None))(matrix, qbytes, qlens)


def _topk_sharded_from_queries(mesh: Mesh, matrix: jax.Array, qbytes,
                               qlens, valid_mask, term_size: int,
                               num_hashes: int, canonicalize: int,
                               sig_sizes: tuple, row_offsets: tuple,
                               k: int):
    """Device-hash variant of _topk_sharded (same candidate contract)."""
    from cobs_tpu.ops.device_hash import rows_from_queries

    zero_row = matrix.shape[0] - 1

    def local(mat, qb, ql, mask):
        rows = rows_from_queries(qb, ql, term_size, num_hashes,
                                 canonicalize, sig_sizes, row_offsets,
                                 zero_row)
        scores = _gather_count_planes(mat, rows, num_hashes)
        return _local_topk(scores, mask, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P("batch", None), P("batch"),
                  P(None, "docs", None)),
        out_specs=(P("batch", "docs"), P("batch", "docs")))(
            matrix, qbytes, qlens, valid_mask)


def _local_topk(scores, mask, k: int):
    """Shard-local top-k + local->global flat-index mapping (shared by
    the host-hashed and device-hashed shard_map locals; the flat index
    runs over the page-major [pages, W_global, 32] score layout,
    matching engine.score_topk's numbering)."""
    Bl, Pp, Wl, _ = scores.shape
    flat = jnp.where(mask, scores, -1).reshape(Bl, Pp * Wl * 32)
    vals, lidx = jax.lax.top_k(flat, k)
    w0 = lax.axis_index("docs") * Wl
    W_glob = Wl * lax.axis_size("docs")
    p = lidx // (Wl * 32)
    r = lidx % (Wl * 32)
    gidx = p * (W_glob * 32) + (w0 * 32 + r)
    return vals, gidx.astype(jnp.int32)


def _topk_seq_sharded(mesh: Mesh, matrix: jax.Array,
                      rows_idx: jax.Array, valid_mask: jax.Array,
                      num_hashes: int, k: int):
    """Sequence-parallel top-k for very long queries.

    The term axis is sharded across the "batch" mesh axis (the same
    split as score_seq_sharded), partial per-document counts merge
    with one psum, and each "docs" shard then ranks its own documents
    exactly like _topk_sharded. The psum replicates scores over the
    "batch" axis, so the local top-k is computed redundantly per batch
    row — k candidate pairs per shard vs the full score matrix, the
    right trade (reference: cobs/query/classic_search.cpp:355-400 is
    the score-batch parallelism being scaled).

    rows_idx: i32 [B, T, h, pages] with T divisible by the "batch"
    axis size, sharded P(None, "batch", None, None). Returns the same
    (vals, global_flat_idx) [B, shards*k] contract as _topk_sharded.
    """

    def local(mat, idx, mask):
        part = _gather_count_planes(mat, idx, num_hashes)
        scores = lax.psum(part, "batch")
        return _local_topk(scores, mask, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None, "batch", None, None),
                  P(None, "docs", None)),
        out_specs=(P(None, "docs"), P(None, "docs")))(
            matrix, rows_idx, valid_mask)


def _topk_sharded(mesh: Mesh, matrix: jax.Array, rows_idx: jax.Array,
                  valid_mask: jax.Array, num_hashes: int, k: int):
    """Per-shard gather-AND-count + local top-k.

    valid_mask: bool [pages, W, 32] sharded P(None, "docs", None).
    Returns (vals i32 [B, shards*k], global_flat_idx i32 [B, shards*k])
    where the flat index runs over the page-major [pages, W, 32] score
    layout (matching engine.score_topk's numbering).
    """

    def local(mat, idx, mask):
        scores = _gather_count_planes(mat, idx, num_hashes)
        return _local_topk(scores, mask, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P("batch", None, None, None),
                  P(None, "docs", None)),
        out_specs=(P("batch", "docs"), P("batch", "docs")))(
            matrix, rows_idx, valid_mask)


def _upload_streamed_sharded(streamed, sharding, word_width: int):
    """Upload a StreamedIndex's payload directly shard-by-shard.

    Each device receives only its own word-column slice, read from the
    memory-mapped file — the full matrix never materializes on any one
    host buffer or chip, so indexes larger than a single chip's HBM
    load as long as the mesh's combined HBM holds them.
    """
    R1 = int(streamed.total_rows) + 1
    shape = (R1, word_width)
    row_bytes = streamed._row_bytes

    built: dict[tuple, np.ndarray] = {}
    arrays = []
    for dev, idx in sharding.addressable_devices_indices_map(
            shape).items():
        col = idx[1]
        c0 = 0 if col.start is None else col.start
        c1 = word_width if col.stop is None else col.stop
        key = (c0, c1)
        if key not in built:
            Wl = c1 - c0
            shard = np.zeros((R1, Wl * 4), dtype=np.uint8)
            b0, b1 = c0 * 4, min(c1 * 4, row_bytes)
            if b1 > b0:
                r = 0
                for mm in streamed._mms:
                    n = mm.shape[0]
                    shard[r:r + n, :b1 - b0] = mm[:, b0:b1]
                    r += n
            built[key] = np.ascontiguousarray(shard).view("<u4")
        arrays.append(jax.device_put(built[key], dev))
    return jax.make_array_from_single_device_arrays(
        shape, sharding, arrays)


def scatter_step(mesh: Mesh, matrix: jax.Array, rows: jax.Array,
                 docs: jax.Array) -> jax.Array:
    """Functional sharded construction step: OR bit `docs[i]` into row
    `rows[i]` of the signature matrix.

    Args:
      matrix: u32 [rows+1, W] sharded P(None, "docs"); the last row is
        the zero row and must stay zero.
      rows: i32 [n] replicated — Bloom row per update (hash % sig_size).
      docs: i32 [n] replicated — global document id per update.
    Returns:
      updated matrix, same sharding.

    Each shard owns documents [w0*32, (w0+Wl)*32); updates outside the
    range are routed to a scratch row that is zeroed before the OR, so
    duplicates and foreign updates are both harmless (scatter-set of an
    indicator is idempotent — the dedup pass of the host path is
    unnecessary here).
    """

    def local(mat, rows, docs):
        R1, Wl = mat.shape
        w0 = lax.axis_index("docs") * Wl
        d_loc = docs - w0 * 32
        valid = (d_loc >= 0) & (d_loc < Wl * 32)
        r = jnp.where(valid, rows, R1 - 1)
        d = jnp.where(valid, d_loc, 0)
        plane = jnp.zeros((R1, Wl, 32), dtype=jnp.uint32)
        plane = plane.at[r, d // 32, d % 32].set(
            jnp.uint32(1), mode="drop")
        delta = jnp.sum(plane << jnp.arange(32, dtype=jnp.uint32),
                        axis=-1, dtype=jnp.uint32)
        delta = delta.at[R1 - 1].set(jnp.uint32(0))   # keep zero row zero
        return mat | delta

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None), P(None)),
        out_specs=P(None, "docs"))(matrix, rows, docs)


def train_step(mesh: Mesh, matrix: jax.Array, rows: jax.Array,
               docs: jax.Array, rows_idx: jax.Array,
               num_hashes: int) -> tuple[jax.Array, jax.Array]:
    """The full sharded step: ingest a batch of bit-set updates into the
    document-sharded matrix, then score a sharded query batch against it.

    This is the end-to-end unit the multi-chip dry run compiles: data
    parallelism on the query batch axis, tensor parallelism on the
    document axis, functional state threading for the matrix.
    """
    new_matrix = scatter_step(mesh, matrix, rows, docs)
    scores = score_sharded(mesh, new_matrix, rows_idx, num_hashes)
    return new_matrix, scores


def assemble_scores(scores: jax.Array, lay) -> np.ndarray:
    """[B, pages, W, 32] device scores -> host int32 [B, counts_size].

    Strips the per-shard word padding, keeping each page's real doc
    slots (page-major layout, matching the reference's 8-aligned score
    offsets, reference: cobs/query/classic_search.cpp:413-429). `lay`
    is the index's engine.DocLayout (or a plain uniform docs-per-page
    int) — uniform pages take the reshape fast path, run-coalesced
    pages concatenate per-page prefixes.
    """
    s = np.asarray(scores).astype(np.int32, copy=False)
    B, Pp = s.shape[0], s.shape[1]
    s = s.reshape(B, Pp, -1)
    if isinstance(lay, (int, np.integer)):   # uniform docs-per-page
        dpp = int(lay)
        return np.ascontiguousarray(
            s[:, :, :dpp].reshape(B, Pp * dpp))
    dpp = lay.uniform_docs
    if dpp is not None:
        return np.ascontiguousarray(
            s[:, :, :dpp].reshape(B, Pp * dpp))
    return np.concatenate(
        [s[:, p, :int(lay.page_docs[p])] for p in range(Pp)], axis=1)


def score_seq_sharded(mesh: Mesh, matrix: jax.Array, rows_idx: jax.Array,
                      num_hashes: int) -> jax.Array:
    """Sequence-axis parallel scoring for very long queries.

    The k-mer axis of a single huge query is split across the "batch"
    mesh axis: each chip counts its slice of terms against the (still
    document-sharded) matrix and per-document scores merge with one
    psum — the plain sequence shard + score reduction SURVEY.md §5
    maps long-context parallelism to (no quadratic interaction exists,
    so no ring machinery is needed).

    Args:
      matrix: u32 [total_rows+1, W] sharded P(None, "docs").
      rows_idx: i32 [B, T, h, pages] with T divisible by the "batch"
        axis size, sharded P(None, "batch", None, None).
    Returns:
      i32 [B, pages, W, 32] sharded P(None, None, "docs", None).
    """

    def local(mat, idx):
        part = _gather_count_planes(mat, idx, num_hashes)
        # psum in int32 (u16 partials could overflow mid-reduction);
        # the fetch then narrows by the FULL term count
        total = lax.psum(part, "batch")
        return _shrink_scores(
            total, idx.shape[1] * lax.axis_size("batch"))

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None, "batch", None, None)),
        out_specs=P(None, None, "docs", None))(matrix, rows_idx)


def score_sharded_multi(mesh: Mesh, matrix: jax.Array,
                        rows_idx: jax.Array,
                        num_hashes: int) -> jax.Array:
    """K-batch mega-dispatch of score_sharded: rows_idx [K, B, T, h,
    pages] -> scores [K, B, pages, W, 32]. The lax.scan lives INSIDE
    the per-shard local, so the hot loop stays collective-free and the
    fixed per-dispatch cost divides by K (engine's mega-dispatch
    extended to the mesh)."""

    def local(mat, idx):
        def step(c, x):
            return c, _shrink_scores(
                _gather_count_planes(mat, x, num_hashes), x.shape[1])

        _, out = lax.scan(step, 0, idx)
        return out

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None, "batch", None, None, None)),
        out_specs=P(None, "batch", None, "docs", None))(matrix,
                                                        rows_idx)


def score_sharded_from_queries_multi(mesh: Mesh, matrix: jax.Array,
                                     qbytes, qlens, term_size: int,
                                     num_hashes: int,
                                     canonicalize: int,
                                     sig_sizes: tuple,
                                     row_offsets: tuple) -> jax.Array:
    """Device-hash variant of score_sharded_multi: qbytes [K, B, L].
    Call under jax.enable_x64()."""
    from cobs_tpu.ops.device_hash import rows_from_queries

    zero_row = matrix.shape[0] - 1

    def local(mat, qb, ql):
        def step(c, x):
            b, l = x
            rows = rows_from_queries(b, l, term_size, num_hashes,
                                     canonicalize, sig_sizes,
                                     row_offsets, zero_row)
            return c, _shrink_scores(
                _gather_count_planes(mat, rows, num_hashes),
                rows.shape[1])

        _, out = lax.scan(step, 0, (qb, ql))
        return out

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None, "batch", None),
                  P(None, "batch")),
        out_specs=P(None, "batch", None, "docs", None))(matrix, qbytes,
                                                        qlens)


def _topk_sharded_multi(mesh: Mesh, matrix: jax.Array,
                        rows_idx: jax.Array, valid_mask: jax.Array,
                        num_hashes: int, k: int):
    """K-batch mega-dispatch of _topk_sharded: [K, B, T, h, pages] ->
    (vals, gidx) [K, B, shards*k]."""

    def local(mat, idx, mask):
        def step(c, x):
            scores = _gather_count_planes(mat, x, num_hashes)
            return c, _local_topk(scores, mask, k)

        _, out = lax.scan(step, 0, idx)
        return out

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None, "batch", None, None, None),
                  P(None, "docs", None)),
        out_specs=(P(None, "batch", "docs"),
                   P(None, "batch", "docs")))(matrix, rows_idx,
                                              valid_mask)


def _topk_sharded_from_queries_multi(mesh: Mesh, matrix: jax.Array,
                                     qbytes, qlens, valid_mask,
                                     term_size: int, num_hashes: int,
                                     canonicalize: int,
                                     sig_sizes: tuple,
                                     row_offsets: tuple, k: int):
    """Device-hash variant of _topk_sharded_multi (qbytes [K, B, L])."""
    from cobs_tpu.ops.device_hash import rows_from_queries

    zero_row = matrix.shape[0] - 1

    def local(mat, qb, ql, mask):
        def step(c, x):
            b, l = x
            rows = rows_from_queries(b, l, term_size, num_hashes,
                                     canonicalize, sig_sizes,
                                     row_offsets, zero_row)
            scores = _gather_count_planes(mat, rows, num_hashes)
            return c, _local_topk(scores, mask, k)

        _, out = lax.scan(step, 0, (qb, ql))
        return out

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None, "batch", None),
                  P(None, "batch"), P(None, "docs", None)),
        out_specs=(P(None, "batch", "docs"),
                   P(None, "batch", "docs")))(matrix, qbytes, qlens,
                                              valid_mask)
