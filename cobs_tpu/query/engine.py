"""Query engine: fused gather -> AND -> bit-count scoring on the device.

Design (batched and device-resident, not a port):

The reference streams byte rows from mmap per score batch, ANDs them with
64-bit scalar ops and expands bits into counters through SSE2 lookup tables
(reference: cobs/query/classic_search.cpp:279-401, 507-1022). Here the
whole index instead lives in device memory as ONE dense uint32 matrix
``[total_rows, W]``:

- classic index: total_rows = signature_size, W = ceil(row_size/4) words;
- compact index: the per-page sub-matrices (page p has its own
  signature_size_p) are stacked row-wise; ``row_offsets[p]`` locates page
  p's block, and every page is padded to the same word width W =
  page_size/4. This is the same uniform-page trick the compact file format
  itself uses (reference: cobs/construction/compact_index.cpp:137-150),
  which makes classic a P=1 special case and gives one engine for both.

A query batch becomes a row-index tensor [B, T, h, P] (hashes modded by the
per-page signature size on the host in uint64). The device then:
  gather rows -> AND across the h hash functions -> count terms per document
  bit position with packed Wallace-tree carry-save adders (_count_csa; ~15x
  fewer vector ops than expanding every term into 32 int32 lanes) -> int32
  scores [B, docs], narrowed to u8/u16 for the host fetch when the query
  length allows (the reference's score-width tiering applied to the
  transfer). Wide indexes stream the gather through term chunks under a
  fixed HBM budget; top-k queries fetch only [B, k] (score, doc) pairs.

Everything is static-shaped (batch and term axes padded to buckets, padding
terms point at a zero row so they contribute nothing) and batched over
queries — batching is the main throughput win over the reference's serial
per-query loop.
"""

import dataclasses
import functools
import os
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from cobs_tpu.core.canonical import canonicalize_batch
from cobs_tpu.core.xxh64 import xxh64_multi_seed
from cobs_tpu.fmt import classic as fmt_classic
from cobs_tpu.fmt import compact as fmt_compact
from cobs_tpu.fmt.magic import FileIOError
from cobs_tpu.ingest.util import sliding_windows
from cobs_tpu.utils.timer import Timer

#: padding of the word axis; 128 words = 512 documents per row tile.
#: Set by the previous accelerator's lane tile; not yet swept on the
#: H100 (ROADMAP 1.3).
_WORD_ALIGN = 128


def _pad_words(n: int) -> int:
    return max(_WORD_ALIGN, -(-n // _WORD_ALIGN) * _WORD_ALIGN)


def _bytes_to_words(rows: np.ndarray, word_width: int) -> np.ndarray:
    """uint8 [R, row_bytes] -> uint32 [R, word_width] little-endian.

    LSB-first byte bits + little-endian words mean: document index ==
    word_index * 32 + bit_index, with no bit shuffling.
    """
    R, row_bytes = rows.shape
    out = np.zeros((R, word_width * 4), dtype=np.uint8)
    out[:, :row_bytes] = rows
    return out.view("<u4")


@dataclasses.dataclass(frozen=True)
class DocLayout:
    """Host-side mapping from device score slots to PUBLIC doc slots.

    The device score tensor is page-major with `w32` slots per page
    (word_width * 32, including per-page word padding); the public
    layout is the reference's 8-aligned slots per ORIGINAL page with
    no word padding (reference: cobs/query/classic_search.cpp:413-429).
    Uniform indexes (classic, and compact merged by a uniform factor)
    have equal `page_docs`; RUN-coalesced compact indexes (consecutive
    equal-Bloom pages merged into variable-width groups) carry true
    per-page doc counts and offsets — runs are consecutive and cover
    the pages in order, so concatenating each merged page's real-doc
    prefix reproduces the exact original slot numbering.
    """

    w32: int
    page_docs: np.ndarray     # int64 [P] real doc slots per page
    doc_offsets: np.ndarray   # int64 [P+1] public slot offsets

    @property
    def num_pages(self) -> int:
        return len(self.page_docs)

    @property
    def counts_size(self) -> int:
        return int(self.doc_offsets[-1])

    @property
    def uniform_docs(self) -> int | None:
        """docs-per-page when every page holds the same count."""
        d = self.page_docs
        if len(d) and (d == d[0]).all():
            return int(d[0])
        return None

    def with_w32(self, w32: int) -> "DocLayout":
        """Same doc mapping over a different padded page row width
        (mesh shards re-pad word_width to the mesh alignment)."""
        return DocLayout(w32, self.page_docs, self.doc_offsets)


def _uniform_layout(num_pages: int, word_width: int,
                    docs_per_page: int) -> DocLayout:
    pd = np.full(num_pages, docs_per_page, dtype=np.int64)
    off = np.zeros(num_pages + 1, dtype=np.int64)
    np.cumsum(pd, out=off[1:])
    return DocLayout(word_width * 32, pd, off)


@dataclasses.dataclass
class DeviceIndex:
    """An index resident in device HBM."""

    #: uint32 [total_rows + 1, W]; the last row is all-zero (gather target
    #: for padding terms)
    matrix: jax.Array
    #: int64 [P] row offset of each page block
    row_offsets: np.ndarray
    #: uint64 [P] per-page signature sizes
    sig_sizes: np.ndarray
    #: words per page row
    word_width: int
    term_size: int
    canonicalize: int
    num_hashes: int
    page_size: int  # bytes per page row
    file_names: list[str]
    path: str = ""
    #: int64 [P] real doc slots per (merged) page; None = uniform
    #: 8*page_size (set by the run-coalesced compact load, where merged
    #: pages span different numbers of original pages)
    page_docs: np.ndarray | None = None

    @property
    def num_pages(self) -> int:
        return len(self.sig_sizes)

    @property
    def doc_layout(self) -> DocLayout:
        if self.page_docs is None:
            return _uniform_layout(self.num_pages, self.word_width,
                                   8 * self.page_size)
        off = np.zeros(self.num_pages + 1, dtype=np.int64)
        np.cumsum(self.page_docs, out=off[1:])
        return DocLayout(self.word_width * 32, self.page_docs, off)

    @property
    def counts_size(self) -> int:
        """Score slots including 8-alignment padding
        (reference: cobs/query/classic_index/search_file.cpp:21-23,
        compact_index/search_file.cpp)."""
        if self.page_docs is not None:
            return int(self.page_docs.sum())
        return 8 * self.page_size * self.num_pages

    @property
    def docs_per_page(self) -> int:
        if self.page_docs is not None:
            raise ValueError(
                "run-coalesced index has variable docs per page; use "
                "doc_layout")
        return 8 * self.page_size

    @classmethod
    def from_classic(cls, path) -> "DeviceIndex":
        with open(path, "rb") as f:
            h = fmt_classic.ClassicIndexHeader.deserialize(f)
            off = f.tell()
        W = _pad_words(-(-h.row_size // 4))
        matrix = _load_matrix_striped(path, off, h.signature_size,
                                      h.row_size, W)
        return cls(matrix=matrix,
                   row_offsets=np.zeros(1, dtype=np.int64),
                   sig_sizes=np.asarray([h.signature_size],
                                        dtype=np.uint64),
                   word_width=W, term_size=h.term_size,
                   canonicalize=h.canonicalize, num_hashes=h.num_hashes,
                   page_size=h.row_size, file_names=h.file_names,
                   path=str(path))

    @classmethod
    def from_compact(cls, path) -> "DeviceIndex":
        h, off = fmt_compact.read_compact_header(path)
        if not h.parameters:
            raise FileIOError("compact index has no pages")
        num_hashes = h.parameters[0].num_hashes
        for p in h.parameters:
            if p.num_hashes != num_hashes:
                raise FileIOError(
                    "compact index with non-uniform num_hashes unsupported")
        sig_sizes = [p.signature_size for p in h.parameters]
        page_size = h.page_size
        # pages with equal Bloom sizes probe the same row per hash, so
        # they merge COLUMN-wise into one wider page bit-exactly
        # (fmt_compact.coalesce_factor) — one gather per term instead
        # of one per page, and wide rows gather faster per byte. The
        # file keeps the reference's space-optimal small pages; this
        # re-layout exists only in HBM (`cobs repack` materializes it).
        coalesce = os.environ.get("COBS_TPU_COALESCE_PAGES",
                                  "1") != "0"
        m = fmt_compact.coalesce_factor(sig_sizes) if coalesce else 1
        page_docs = None
        if m > 1:
            matrix, sig_sizes = _load_matrix_coalesced(
                path, off, sig_sizes, page_size, m)
            page_size *= m
            W = matrix.shape[1]
        else:
            runs = (fmt_compact.coalesce_runs(sig_sizes)
                    if coalesce else [])
            if any(n > 1 for _, n in runs):
                # cap skewed runs so short runs stop padding to the
                # longest one (bit-exact: chunk boundaries are page
                # boundaries). COBS_TPU_RUN_CAP: unset/auto = cost
                # model, 0 = uncapped (pad to the widest run), N =
                # forced cap (A/B + escape hatch)
                cap_env = os.environ.get("COBS_TPU_RUN_CAP", "")
                if cap_env in ("", "auto"):
                    cap = _best_run_cap(runs, page_size)
                else:
                    cap = int(cap_env) or max(n for _, n in runs)
                runs = _split_runs(runs, cap)
            if any(n > 1 for _, n in runs) and _runs_worthwhile(
                    runs, sig_sizes, page_size):
                # no uniform factor (size tiers straddle page
                # boundaries), but equal-Bloom RUNS still merge
                # column-wise bit-exactly; merged pages span variable
                # numbers of original pages, tracked by per-page doc
                # counts (DocLayout)
                matrix, sig_sizes = _load_matrix_coalesced(
                    path, off, sig_sizes, page_size, 0, runs=runs)
                page_docs = np.asarray(
                    [8 * page_size * n for _, n in runs],
                    dtype=np.int64)
                page_size *= max(n for _, n in runs)
                W = matrix.shape[1]
            else:
                W = _pad_words(-(-page_size // 4))
                matrix = _load_matrix_striped(path, off,
                                              int(sum(sig_sizes)),
                                              page_size, W)
        if page_size * len(sig_sizes) > 1024 and page_size < 512:
            import sys
            print(f"NOTE: compact index has {len(sig_sizes)} pages of "
                  f"{page_size} B (after equal-size coalescing); pages "
                  "below 512 B pad to the 128-word row alignment and "
                  "multiply gather traffic — consider "
                  "constructing with --page-size >= 512 or running "
                  "`cobs repack` for query-heavy workloads",
                  file=sys.stderr)
        offsets = np.zeros(len(sig_sizes), dtype=np.int64)
        np.cumsum(sig_sizes[:-1], out=offsets[1:])
        return cls(matrix=matrix, row_offsets=offsets,
                   sig_sizes=np.asarray(sig_sizes, dtype=np.uint64),
                   word_width=W, term_size=h.term_size,
                   canonicalize=h.canonicalize, num_hashes=num_hashes,
                   page_size=page_size, file_names=h.file_names,
                   path=str(path), page_docs=page_docs)

    @classmethod
    def from_file(cls, path) -> "DeviceIndex":
        if fmt_classic.is_classic_file(path):
            return cls.from_classic(path)
        if fmt_compact.is_compact_file(path):
            return cls.from_compact(path)
        raise FileIOError(f'Could not open index path "{path}"')

    @property
    def zero_row(self) -> int:
        return self.matrix.shape[0] - 1

    def row_indices(self, hashes: np.ndarray) -> np.ndarray:
        """uint64 hashes [T, h] -> int32 row indices [T, h, P]
        (per-page modulo, reference:
        cobs/query/compact_index/mmap_search_file.cpp:55-66)."""
        idx = (hashes[:, :, None] % self.sig_sizes[None, None, :]
               + self.row_offsets[None, None, :].astype(np.uint64))
        if self.matrix.shape[0] <= np.iinfo(np.int32).max:
            return idx.astype(np.int32)
        raise ValueError("index too large for int32 row addressing")


#: payload bytes per host-to-device transfer when loading an index into
#: device memory. A whole-payload read + one monolithic device_put
#: doubles host RSS; stripes bound the extra host memory to one stripe
#: and keep every transfer modest. The reference's analog is the mmap
#: load that never copies twice (reference: cobs/util/query.cpp:38-88).
_UPLOAD_STRIPE_BYTES = 64 << 20


@functools.partial(jax.jit, static_argnums=(0, 1))
def _zeros_u32(R: int, W: int):
    return jnp.zeros((R, W), jnp.uint32)


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_stripe(buf, stripe, row0):
    return lax.dynamic_update_slice(buf, stripe, (row0, 0))


def _load_matrix_striped(path, payload_off: int, total_rows: int,
                         row_bytes: int, W: int) -> jax.Array:
    """Load an index payload into a device u32 [total_rows + 1, W]
    matrix stripe by stripe (the last row stays the all-zero gather
    target). Donated in-place updates keep peak HBM at matrix + one
    stripe; at most two stripe shapes compile (full + remainder)."""
    buf = _zeros_u32(total_rows + 1, W)
    rows_per = max(1, _UPLOAD_STRIPE_BYTES // (W * 4))
    with open(path, "rb") as f:
        f.seek(payload_off)
        r = 0
        while r < total_rows:
            n = min(rows_per, total_rows - r)
            raw = np.fromfile(f, dtype=np.uint8, count=n * row_bytes)
            if raw.size != n * row_bytes:
                raise FileIOError("index payload truncated")
            words = _bytes_to_words(raw.reshape(n, row_bytes), W)
            buf = _write_stripe(buf, jnp.asarray(words), np.int32(r))
            r += n
    return buf


def _best_run_cap(runs, page_size: int) -> int:
    """Pages-per-merged-page cap minimizing padded gather bytes/term.

    Run-length merging pads every merged page to the WIDEST run, so a
    skewed run profile (one long run + short tails) gathers mostly
    zero padding. Splitting long runs at a cap trades more gathers for
    narrower rows: per-term gathered bytes at cap m are
    sum(ceil(len_i / m)) * tile_padded_bytes(m * page_size) — split
    chunks stay bit-exact because chunk boundaries are original page
    boundaries. Among caps within 5% of the cheapest, the WIDEST wins:
    gather bandwidth rose with row width on the previous accelerator
    (not yet measured on the H100, PERF.md), so byte parity favors
    fewer, wider pages."""
    def padb(m):
        return _pad_words(-(-(page_size * m) // 4)) * 4

    costs = {m: sum(-(-n // m) for _, n in runs) * padb(m)
             for m in range(1, max(n for _, n in runs) + 1)}
    cmin = min(costs.values())
    return max(m for m, c in costs.items() if c <= 1.05 * cmin)


def _split_runs(runs, cap: int):
    """Split every run into chunks of at most `cap` pages."""
    out = []
    for s, n in runs:
        while n > cap:
            out.append((s, cap))
            s += cap
            n -= cap
        out.append((s, n))
    return out


def _runs_worthwhile(runs, sig_sizes, page_size: int) -> bool:
    """Whether run-length merging pays: every merged page zero-pads to
    the WIDEST run's width, so a skewed run profile (one long run plus
    distinct-size tails) can inflate HBM footprint and per-term gather
    bytes past the unmerged layout. Merge only when both shrink-or-
    hold: merged gather bytes per term <= unmerged, and merged HBM
    <= 1.25x unmerged (both computed on the 128-word-padded widths the
    device actually stores)."""
    max_len = max(n for _, n in runs)
    merged_row = _pad_words(-(-(page_size * max_len) // 4)) * 4
    plain_row = _pad_words(-(-page_size // 4)) * 4
    if merged_row * len(runs) > plain_row * len(sig_sizes):
        return False
    merged_hbm = sum(int(sig_sizes[s]) for s, _ in runs) * merged_row
    plain_hbm = int(sum(sig_sizes)) * plain_row
    return merged_hbm <= 1.25 * plain_hbm


def _load_matrix_coalesced(path, payload_off: int, sig_sizes: list,
                           page_size: int, m: int, runs=None):
    """Load a compact payload with groups of equal-signature pages
    merged column-wise into wider rows.

    Merged page g row r = concat of member pages' row r (identical row
    id per hash because the signature sizes are equal). Uniform mode
    (runs=None): groups of `m` pages, m | page count
    (fmt_compact.coalesce_factor) — every group is full, so the public
    score layout (counts_size, doc numbering) is byte-identical with
    the uniform docs-per-page math. Run mode (runs=[(start, len)...]):
    variable-length equal-signature runs merge into pages of different
    widths, all zero-padded to the widest run; the caller must then
    carry per-page doc counts (DeviceIndex.page_docs). Returns
    (matrix u32 [rows'+1, W'], merged sig_sizes).
    """
    if runs is None:
        runs = [(i, m) for i in range(0, len(sig_sizes), m)]
    groups = [list(range(s, s + n)) for s, n in runs]
    merged_sigs = [int(sig_sizes[g[0]]) for g in groups]
    max_len = max(n for _, n in runs)
    W = _pad_words(-(-(page_size * max_len) // 4))
    total_rows = sum(merged_sigs)
    buf = _zeros_u32(total_rows + 1, W)
    offs = np.zeros(len(sig_sizes) + 1, dtype=np.int64)
    np.cumsum(np.asarray(sig_sizes, dtype=np.int64) * page_size,
              out=offs[1:])
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=payload_off,
                   shape=(int(offs[-1]),))
    rows_per = max(1, _UPLOAD_STRIPE_BYTES // (W * 4))
    r_out = 0
    for g, sig in zip(groups, merged_sigs):
        r = 0
        while r < sig:
            n = min(rows_per, sig - r)
            stripe = np.zeros((n, W * 4), dtype=np.uint8)
            for j, p in enumerate(g):
                blk = mm[offs[p] + r * page_size:
                         offs[p] + (r + n) * page_size]
                stripe[:, j * page_size:(j + 1) * page_size] = \
                    blk.reshape(n, page_size)
            buf = _write_stripe(buf, jnp.asarray(stripe.view("<u4")),
                                np.int32(r_out + r))
            r += n
        r_out += sig
    return buf, merged_sigs


def create_hashes(queries: list[bytes], term_size: int, num_hashes: int,
                  canonicalize: int) -> list[np.ndarray]:
    """Per query: uint64 [num_terms, num_hashes] raw (un-modded) XXH64
    (reference: cobs/query/classic_search.cpp:66-107)."""
    from cobs_tpu import native

    if canonicalize not in (0, 1):
        raise ValueError(f"Unknown canonicalize value {canonicalize}")
    out = []
    for q in queries:
        windows = sliding_windows(np.frombuffer(q, dtype=np.uint8),
                                  term_size)
        if windows.shape[0] == 0:
            raise ValueError(
                f"query too short, needs to be at least {term_size} "
                "characters long")
        nat = native.window_hashes(windows, num_hashes, canonicalize)
        if nat is not None:
            hashes, good_all = nat
            if canonicalize == 1 and not good_all:
                raise ValueError("Invalid DNA base pair in query string. "
                                 "Only ACGT are allowed.")
            out.append(hashes)
            continue
        if canonicalize == 1:
            windows, good = canonicalize_batch(windows)
            if not good.all():
                raise ValueError("Invalid DNA base pair in query string. "
                                 "Only ACGT are allowed.")
        out.append(xxh64_multi_seed(np.ascontiguousarray(windows),
                                    num_hashes))
    return out


def _bucket(n: int) -> int:
    """Pad axis sizes to buckets to bound jit recompilation.

    Rounds up to a multiple of 2^(bit_length-4) — eight steps per
    octave — so padding waste on the dominant term axis is capped at
    12.5% (mean ~6%) while the number of distinct compiled programs
    stays O(log n). Zero-row padding terms gather like real ones, so the
    padding is paid in device time: T=1000 pads to 1024 (+2.4%)."""
    if n <= 16:
        return 16
    q = 1 << max(4, n.bit_length() - 4)
    return -(-n // q) * q


def _csa(a, b, c):
    """Carry-save full adder on packed bit planes: 5 vector ops."""
    u = a ^ b
    return u ^ c, (a & b) | (u & c)


def _expand32(plane):
    """u32 [...] -> i32 [..., 32] per-document indicators."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return ((plane[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int32)


_CSA_CHUNK = 128


def _count_csa(anded: jax.Array) -> jax.Array:
    """Per-bit-position counts over the term axis via a Wallace tree of
    packed bit-plane adders.

    anded: u32 [B, T, P, W]. Returns i32 [B, P, W, 32].

    The naive formulation expands every term's row into 32 int32
    document lanes before the T-reduction (~32x the vector work of the
    data gathered). Here the T
    indicator planes are reduced in packed form: repeated *strided*
    carry-save adders combine plane triples across the whole array
    (sum planes keep the current weight, carry planes promote to the
    next power of two), so the count stays as ~log2(T) bit planes per
    weight until a single expansion per weight at the end. ~O(T)
    packed word ops total but only O(log^2 T) HLO ops — fast to
    compile, and ~15x less vector work than the naive expansion.

    Layout: the (P, W) axes are flattened before the tree, so no op
    carries a unit P axis as a minor dimension (which the previous
    accelerator's tiled layout padded 8x; not measured on the H100).
    """
    B, T, P, W = anded.shape
    total = jnp.zeros((B, P * W, 32), jnp.int32)
    cur = anded.reshape(B, T, P * W)  # weight 2^k planes, k = 0
    k = 0
    while cur is not None and k < 32:
        carries = []
        while cur.shape[1] > 1:
            m = cur.shape[1]
            if m == 2:               # half adder
                a, b = cur[:, 0:1], cur[:, 1:2]
                carries.append(a & b)
                cur = a ^ b
                continue
            n3 = m // 3 * 3
            a, b, c = cur[:, 0:n3:3], cur[:, 1:n3:3], cur[:, 2:n3:3]
            s, carry = _csa(a, b, c)
            if m != n3:
                s = jnp.concatenate([s, cur[:, n3:]], axis=1)
            carries.append(carry)
            cur = s
        total = total + (_expand32(cur[:, 0]) << k)
        cur = (jnp.concatenate(carries, axis=1)
               if carries else None)
        k += 1
    return total.reshape(B, P, W, 32)


#: bound on the materialized gathered tensor (bytes); batches whose
#: [B, T, h, P, W] gather would exceed it stream through T-chunks.
#: Tuned on the previous accelerator; not yet swept on the H100
#: (ROADMAP 1.3).
_GATHER_BYTES_BUDGET = 1 << 30

#: target term-chunk for the gather->count scan. Streaming T in chunks
#: lets XLA overlap each chunk's gather with the previous chunk's
#: packed count, and bounds the materialized block. The actual chunk
#: adapts to T so the last chunk carries no padding: the divisor of T
#: closest to the target wins, because padding terms still gather the
#: zero row. Tuned on the previous accelerator; not yet swept on the
#: H100 (ROADMAP 1.3).
_COUNT_CHUNK = 500


def _chunk_for(T: int, target: int) -> int:
    """Largest chunk <= target that pads T the least: ceil-divide T
    into ceil(T/target) chunks. Zero padding whenever T has a divisor
    near the target (serving buckets are multiples of 16, so usually)."""
    n = -(-T // target)
    return -(-T // n)


def _plan_chunks(T: int, h: int, budget_terms: int) -> int | None:
    """Scan chunk size for a T-term gather->count, or None = single
    shot. Invariant: a returned chunk is >= _CSA_CHUNK whenever
    T//2 >= _CSA_CHUNK, so no chunk drops to the naive expand-sum
    count (~15x the packed-CSA VPU work) — the one exception is a
    budget too small for even one _CSA_CHUNK-term gather."""
    # target scales inversely with num_hashes so each chunk gathers a
    # constant byte volume (h rows per term)
    tc = max(_CSA_CHUNK, _COUNT_CHUNK // h)
    if budget_terms < tc:
        tc = max(_CSA_CHUNK, budget_terms // _CSA_CHUNK * _CSA_CHUNK)
    if T <= tc or (T <= 2 * _CSA_CHUNK and budget_terms >= T):
        # splitting a T <= 2*_CSA_CHUNK axis would drop every chunk
        # below the packed-CSA floor
        return None
    # >= 2 chunks (the scan overlap needs at least two), sized to a
    # divisor of T near the target so the tail chunk carries no padding
    tc = _chunk_for(T, min(tc, -(-T // 2)))
    if tc < _CSA_CHUNK <= T // 2:
        # a divisor chunk below the CSA floor costs more in naive
        # counting than its zero padding saves in gather traffic: take
        # the largest chunk count that keeps every chunk >= _CSA_CHUNK
        tc = -(-T // max(2, T // _CSA_CHUNK))
    return tc


def _gather_and(matrix, rows_idx, num_hashes):
    """take + AND across hash planes: [B, T, h, P] -> [B, T, P, W].

    Indices flatten to 2-D before the take, so the gather carries no
    trailing unit h/P axes."""
    B, T, h, P = rows_idx.shape
    if num_hashes == 1:
        # no AND fold: skip the 5-D round trip through the unit h axis
        g = jnp.take(matrix, rows_idx.reshape(B, T * P), axis=0)
        return g.reshape(B, T, P, matrix.shape[1])
    g = jnp.take(matrix, rows_idx.reshape(B, T * h * P), axis=0)
    g = g.reshape(B, T, h, P, matrix.shape[1])      # u32
    anded = g[:, :, 0]
    for j in range(1, num_hashes):
        anded = anded & g[:, :, j]
    return anded


def _csa_to_planes(anded2d, L: int):
    """Strided Wallace tree reduced to ONE packed plane per weight,
    WITHOUT the int32 expansion: u32 [B, T, PW] -> u32 [L, B, PW]
    (weight 2^k at index k; missing weights are zero planes). The
    plane form is what crosses scan-chunk boundaries in the wide-row
    accumulator (_gather_count_block planes_acc) — L words instead of
    a [B, PW, 32] int32 read-modify-write per chunk."""
    out = []
    cur = anded2d
    k = 0
    while cur is not None and k < L:
        carries = []
        while cur.shape[1] > 1:
            m = cur.shape[1]
            if m == 2:
                a, b = cur[:, 0:1], cur[:, 1:2]
                carries.append(a & b)
                cur = a ^ b
                continue
            n3 = m // 3 * 3
            a, b, c = cur[:, 0:n3:3], cur[:, 1:n3:3], cur[:, 2:n3:3]
            s, carry = _csa(a, b, c)
            if m != n3:
                s = jnp.concatenate([s, cur[:, n3:]], axis=1)
            carries.append(carry)
            cur = s
        out.append(cur[:, 0])
        cur = jnp.concatenate(carries, axis=1) if carries else None
        k += 1
    while len(out) < L:
        out.append(jnp.zeros_like(out[0]))
    return jnp.stack(out)


def _bitplane_add(a, b):
    """Ripple-carry add of two L-plane packed numbers [L, B, PW] u32.
    Exact when both operands are < 2^(L-1) (the caller sizes L so the
    running count can never reach the top weight)."""
    L = a.shape[0]
    c = jnp.zeros_like(a[0])
    outs = []
    for k in range(L):
        ak, bk = a[k], b[k]
        u = ak ^ bk
        outs.append(u ^ c)
        c = (ak & bk) | (c & u)
    return jnp.stack(outs)


def _gather_count_once(matrix, rows_idx, num_hashes):
    anded = _gather_and(matrix, rows_idx, num_hashes)
    B, T, P, W = anded.shape
    if T >= _CSA_CHUNK:
        return _count_csa(anded)                     # [B, P, W, 32]
    # short queries: naive expand-sum (flattened (P, W) for the same
    # tiling reason as _count_csa)
    flat = anded.reshape(B, T, P * W)
    return jnp.sum(_expand32(flat), axis=1).reshape(B, P, W, 32)


#: fused-chunk byte bound: one term-chunk's gathered block
#: [Bs, tc, h, P, W] u32. The headline 10k-doc config runs at ~33 MiB;
#: at wide rows a full-batch chunk is hundreds of MB and the packed-CSA
#: count's plane intermediates spill to device memory, multiplying
#: traffic. Tiling the batch axis keeps chunks near this bound with
#: full-width rows still feeding the gather. Tuned on the previous
#: accelerator; not yet swept on the H100 (ROADMAP 1.3).
_FUSED_CHUNK_BYTES = 48 << 20


def _plan_batch_tile(B: int, tc: int, h: int, P: int, W: int) -> int:
    """Largest divisor Bs of B whose [Bs, tc, h, P, W] gathered chunk
    stays under _FUSED_CHUNK_BYTES (>= 1)."""
    chunk_words = tc * h * P * W
    Bs = B
    while Bs > 1 and (B % Bs or Bs * chunk_words * 4 > _FUSED_CHUNK_BYTES):
        Bs -= 1
    return Bs


def _plan_tile(B: int, T: int, h: int, P: int, W: int,
               tc0: int | None) -> tuple[int, int | None]:
    """Joint (Bs, tc) plan. Narrow rows keep the full batch and the
    near-500 term chunk (tc0). In the wide-row regime (a full-batch
    chunk would blow _FUSED_CHUNK_BYTES): fix Bs at the largest divisor
    of B <= 8, then take the largest divisor-snapped term chunk that
    fits the budget; fall back to the tc-first plan when even a
    CSA-floor chunk cannot fit at that Bs. The batch tile of 8 was
    tuned on the previous accelerator (its 8-row register tile); not
    yet swept on the H100 (ROADMAP 1.3)."""
    Bs = _plan_batch_tile(B, tc0 if tc0 else T, h, P, W)
    if Bs == B or T <= 2 * _CSA_CHUNK:
        return Bs, tc0
    Bs8 = next((d for d in (8, 4, 2, 1) if B % d == 0), 1)
    budget_tc = _FUSED_CHUNK_BYTES // max(Bs8 * h * P * W * 4, 1)
    if budget_tc >= _CSA_CHUNK:
        tc = _chunk_for(T, min(budget_tc, -(-T // 2)))
        if tc < _CSA_CHUNK <= T // 2:
            tc = -(-T // max(2, T // _CSA_CHUNK))
        if tc >= _CSA_CHUNK and Bs8 * tc * h * P * W * 4                 <= _FUSED_CHUNK_BYTES:
            return Bs8, tc
    return Bs, tc0


def _gather_count_block(matrix, rows_idx, num_hashes, tc,
                        planes_acc=False):
    """rows block [Bs, T', h, P] -> [Bs, P, W, 32]; tc None = single
    shot, else T' % tc == 0 and the term axis streams through a
    lax.scan of tc-term chunks.

    planes_acc: carry the running count as ~log2(T) PACKED bit planes
    (u32 [L, Bs, PW]) instead of the expanded int32 [Bs, P, W, 32]
    accumulator, expanding ONCE after the scan. In the wide-row tiled
    regime the expanded accumulator's read-modify-write plus the
    per-chunk expansion write are ~40% of the chunk's gather bytes;
    the plane carry cuts that to ~L words. Callers enable it only when
    batch-tiling is active (at full-batch narrow rows it lost on the
    previous accelerator; not yet measured on the H100)."""
    if tc is None:
        return _gather_count_once(matrix, rows_idx, num_hashes)
    Bs, Tp, h, P = rows_idx.shape
    W = matrix.shape[1]
    chunks = jnp.moveaxis(
        rows_idx.reshape(Bs, Tp // tc, tc, h, P), 1, 0)

    # data-derived zero: inside shard_map the carry must share the
    # body output's varying manual axes (matrix varies over the doc
    # shard axis, rows_idx over the batch axis); XLA folds this to a
    # plain zeros fill
    zero = ((matrix[-1, 0] & jnp.uint32(0)).astype(jnp.int32)
            + rows_idx[0, 0, 0, 0] * 0)

    if planes_acc:
        L = Tp.bit_length() + 1   # running count <= Tp < 2^(L-1)

        def pbody(acc, idx_c):
            anded = _gather_and(matrix, idx_c, num_hashes)
            planes = _csa_to_planes(anded.reshape(Bs, tc, P * W), L)
            return _bitplane_add(acc, planes), None

        acc0 = (jnp.zeros((L, Bs, P * W), jnp.uint32)
                + zero.astype(jnp.uint32))
        acc, _ = lax.scan(pbody, acc0, chunks)
        total = jnp.zeros((Bs, P * W, 32), jnp.int32) + zero
        for k in range(L):
            total = total + (_expand32(acc[k]) << k)
        return total.reshape(Bs, P, W, 32)

    def body(acc, idx_c):
        return acc + _gather_count_once(matrix, idx_c, num_hashes), None

    acc0 = jnp.zeros((Bs, P, W, 32), jnp.int32) + zero
    scores, _ = lax.scan(body, acc0, chunks)
    return scores


def _gather_count_planes(matrix: jax.Array, rows_idx: jax.Array,
                         num_hashes: int) -> jax.Array:
    """matrix u32 [R, W], rows_idx i32 [B, T, h, P] -> i32 [B, P, W, 32].

    The fused hot path (plain traceable function, so shard_map locals
    reuse it on their matrix shard): XLA lowers the take() to
    dynamic-slice gathers from HBM; the term reduction uses packed
    carry-save counting (_count_csa) when T is chunk-aligned, the naive
    expand-sum otherwise (short queries, where it is cheap anyway).
    Long queries stream the term axis through a lax.scan of
    _COUNT_CHUNK-term chunks — the scan pipeline overlaps each chunk's
    HBM gather with the previous chunk's count, and also bounds the
    materialized gather under the memory budget. Wide rows (many
    documents, or many compact pages) additionally tile the BATCH axis
    so each fused chunk stays near _FUSED_CHUNK_BYTES — full-width rows
    keep the wide-row gather bandwidth while the count's working set
    stays small.
    """
    B, T, h, P = rows_idx.shape
    W = matrix.shape[1]
    # budget the term chunk PER QUERY (Bs can always shrink to 1):
    # clamping tc by the full-B budget would push wide-row shapes to
    # 128-term chunks — far below the _COUNT_CHUNK target — even though
    # batch tiling is about to bound the materialized block anyway
    budget_terms = _GATHER_BYTES_BUDGET // max(h * P * W * 4, 1)
    tc0 = _plan_chunks(T, h, budget_terms)
    Bs, tc = _plan_tile(B, T, h, P, W, tc0)
    pad = (-T) % tc if tc else 0
    if pad:
        # padding terms point at the all-zero last row
        rows_idx = jnp.concatenate([
            rows_idx,
            jnp.full((B, pad, h, P), matrix.shape[0] - 1, jnp.int32)],
            axis=1)
    if Bs == B:
        return _gather_count_block(matrix, rows_idx, num_hashes, tc)
    sub = rows_idx.reshape(B // Bs, Bs, T + pad, h, P)
    out = lax.map(
        lambda rs: _gather_count_block(matrix, rs, num_hashes, tc,
                                       planes_acc=True), sub)
    return out.reshape(B, P, W, 32)


@functools.partial(jax.jit, static_argnames=("num_hashes",))
def _gather_and_count(matrix: jax.Array, rows_idx: jax.Array,
                      num_hashes: int) -> jax.Array:
    """Jitted wrapper: scores flattened to i32 [B, P*W*32]."""
    B = rows_idx.shape[0]
    return _gather_count_planes(matrix, rows_idx,
                                num_hashes).reshape(B, -1)


def _shrink_scores(scores: jax.Array, t_max: int) -> jax.Array:
    """Narrow the score dtype for the device-to-host fetch.

    Scores are bounded by the padded term count, so they fit u8/u16 for
    short/medium queries — the reference's score-width tiering
    (reference: cobs/query/classic_search.cpp:453-500) applied to the
    transfer: int32 stays the on-device accumulator, the fetch shrinks
    4x/2x (which is what the host round trip is bound by).
    """
    if t_max <= 255:
        return scores.astype(jnp.uint8)
    if t_max <= 65535:
        return scores.astype(jnp.uint16)
    return scores


class PendingScores:
    """Handle for a dispatched-but-unfetched device score batch.

    Keeping a *bounded* number of batches in flight overlaps batch k's
    device-to-host fetch with batch k+1's device work. fetch() performs
    the device-to-host materialization.
    """

    __slots__ = ("_dev", "_B", "_lay", "_after")

    def __init__(self, dev, B, layout: DocLayout, after=None):
        self._dev = dev
        self._B = B
        self._lay = layout
        self._after = after

    def fetch(self) -> np.ndarray:
        """int32 [B, counts_size]; the exact score_batch contract.

        Strips the per-page word padding (scores come off the device in
        the padded [B, P*W*32] layout); without the strip, doc numbering
        is shifted for every page after the first whenever the page's
        word width exceeds page_size/4 — the reference's global score
        layout is 8*page_size slots per page with no word padding
        (reference: cobs/query/classic_search.cpp:413-429).
        """
        scores = np.asarray(jax.block_until_ready(self._dev))[:self._B]
        out = _strip_word_padding(scores, self._B, self._lay)
        if self._after is not None:
            self._after()
        return out


def _strip_word_padding(scores: np.ndarray, B: int,
                        lay: DocLayout) -> np.ndarray:
    """Device [B, P*W*32] scores -> the public int32 [B, counts_size]
    contract (restores the dtype after the narrowed transfer and drops
    per-page word padding — and, on run-coalesced indexes, each merged
    page's phantom tail beyond its real doc count)."""
    scores = scores.astype(np.int32, copy=False)
    P, w32 = lay.num_pages, lay.w32
    dpp = lay.uniform_docs
    if P == 1:
        return scores[:, :int(lay.page_docs[0])]
    if dpp is not None:
        return (scores.reshape(B, P, w32)[:, :, :dpp]
                .reshape(B, P * dpp))
    pages = scores.reshape(B, P, w32)
    return np.concatenate(
        [pages[:, p, :int(lay.page_docs[p])] for p in range(P)],
        axis=1)


def _slot_doc_numbers(idx: np.ndarray, lay: DocLayout) -> np.ndarray:
    """Flat padded score-slot ids -> global document numbers (the
    page-major numbering of score_batch's output)."""
    idx = idx.astype(np.int64, copy=False)  # u16 fetches would overflow
    page, local = idx // lay.w32, idx % lay.w32
    dpp = lay.uniform_docs
    if dpp is not None:
        return page * dpp + local
    return lay.doc_offsets[page] + local


class PendingTopK:
    """Handle for a dispatched-but-unfetched device top-k batch; the
    top-k analog of PendingScores (fetch overlaps later dispatches)."""

    __slots__ = ("_vals", "_idx", "_tier", "_B", "_lay", "_after")

    def __init__(self, vals, idx, B, layout: DocLayout,
                 after=None, tier=None):
        self._vals = vals
        self._idx = idx
        self._tier = tier
        self._B = B
        self._lay = layout
        self._after = after

    def fetch(self):
        """(scores i32 [B, k], doc_numbers i64 [B, k]); the exact
        score_topk contract."""
        vals = _unshrink_topk_vals(
            np.asarray(jax.block_until_ready(self._vals))[:self._B])
        idx = np.asarray(self._idx)[:self._B]
        docs = _slot_doc_numbers(idx, self._lay)
        if self._after is not None:
            self._after()
        return vals, docs

    def fetch_topk(self, lims, cap: int):
        """Threshold-compacted fetch: read the packed u32 [B, TIER]
        prefix (8x narrower than the full u16 pair fetch) and
        return it when every row's ranked results provably fit
        (_tier_sufficient, from the same score floors the caller
        ranks with); escalate to the full fetch otherwise. Both paths
        are prefixes of the same device-sorted rows, so results are
        identical — only the transfer width differs."""
        if self._tier is None:
            return self.fetch()
        t = np.asarray(jax.block_until_ready(self._tier))[:self._B]
        v, i = _tier_unpack(t)
        if not _tier_sufficient(v, lims, cap):
            _tier_counters["full_fetches"] += 1
            return self.fetch()
        _tier_counters["tier_fetches"] += 1
        docs = _slot_doc_numbers(i, self._lay)
        if self._after is not None:
            self._after()
        return v, docs


class PendingHost:
    """Pending handle over host-thread scoring (streamed backend): the
    native kernel releases the GIL, so one worker thread gives real
    overlap with the main thread's ranking without touching the device
    (host scoring makes no device transfers)."""

    __slots__ = ("_fut", "_after", "_wt", "_into")

    def __init__(self, fut, after=None, worker_timer=None,
                 merge_into=None):
        self._fut = fut
        self._after = after
        self._wt = worker_timer
        self._into = merge_into

    def fetch(self):
        out = self._fut.result()
        if self._after is not None:
            self._after()
        if self._wt is not None and self._into is not None:
            # fold the worker thread's io/score phases into the
            # caller's timer so pipelined RESULT lines still attribute
            # time per phase (reference: cobs/util/timer.cpp:67-75
            # merges per-thread timers the same way)
            self._into.merge(self._wt)
        return out


class QueryBytes:
    """Marker payload for the device-hash serving path.

    Wraps raw (validated) query byte strings; the engine's scorers
    hash them ON DEVICE (ops/device_hash: window -> canonicalize ->
    XXH64 -> per-page mod) inside the scoring program, so the
    host->device transfer is the ~1 KB/query of raw bytes instead of
    4 bytes per (term, hash, page) of precomputed row indices, and the
    host spends no CPU hashing. Produced by Search for device-resident
    matrices: plain DeviceIndex backends and mesh-sharded search
    (settings.device_hash)."""

    __slots__ = ("queries", "packed", "lens", "t_max", "packed_len")

    def __init__(self, queries: list[bytes]):
        self.queries = queries
        #: optional host-side prepack (prepack_query_bytes): the
        #: padded+2-bit-packed [B_pad, *] u8 array, its i32 lengths,
        #: term bucket, and pre-pack row length. Filled by Search's
        #: hashing stage so the pack runs on the overlapped worker
        #: thread instead of inside the dispatch (io) phase; consumers
        #: that pack differently (mesh shards) simply ignore it.
        self.packed = None
        self.lens = None
        self.t_max = None
        self.packed_len = None

    def __len__(self):
        return len(self.queries)


def _pack_query_bytes(queries: list[bytes], term_size: int,
                      b_pad: int | None = None,
                      t_pad: int | None = None):
    """Pad queries to bucketed [B_pad, L_pad] u8 + true lengths i32.

    Padding bytes are 'A' (any valid letter works — terms past a
    query's true end are masked to the zero row on device). b_pad
    overrides the batch-axis padding (mesh callers round to the
    "batch" axis size instead of the jit bucket); t_pad overrides the
    term-axis bucket (multi-batch dispatch pads every batch of a group
    to the group maximum so one compiled program serves all of them)."""
    B_pad = _bucket(len(queries)) if b_pad is None else b_pad
    L_max = max(len(q) for q in queries)
    T_max = _bucket(L_max - term_size + 1) if t_pad is None else t_pad
    L_pad = T_max + term_size - 1
    qb = np.full((B_pad, L_pad), ord("A"), dtype=np.uint8)
    lens = np.zeros(B_pad, dtype=np.int32)
    _fill_query_rows(qb, lens, queries)
    return qb, lens, T_max


def _fill_query_rows(qb: np.ndarray, lens: np.ndarray, queries) -> None:
    """Copy query bytes into padded rows. Uniform-length batches (the
    serving common case) fill with ONE C-level join+reshape copy
    instead of a per-query loop."""
    n = len(queries)
    L0 = len(queries[0]) if n else 0
    if n and all(len(q) == L0 for q in queries):
        qb[:n, :L0] = np.frombuffer(
            b"".join(queries), dtype=np.uint8).reshape(n, L0)
        lens[:n] = L0
        return
    for b, q in enumerate(queries):
        a = np.frombuffer(q, dtype=np.uint8)
        qb[b, :a.size] = a
        lens[b] = a.size


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8, 9))
def _hash_gather_count(matrix, qdata, qlens, term_size, num_hashes,
                       canonicalize, sig_sizes, row_offsets, zero_row,
                       packed_len):
    from cobs_tpu.ops.device_hash import rows_from_queries

    rows = rows_from_queries(qdata, qlens, term_size, num_hashes,
                             canonicalize, sig_sizes, row_offsets,
                             zero_row, packed_len)
    return _gather_count_planes(matrix, rows,
                                num_hashes).reshape(rows.shape[0], -1)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10, 11))
def _hash_gather_count_topk(matrix, qdata, qlens, valid_mask,
                            term_size, num_hashes, canonicalize,
                            sig_sizes, row_offsets, zero_row, k,
                            packed_len):
    from cobs_tpu.ops.device_hash import rows_from_queries

    rows = rows_from_queries(qdata, qlens, term_size, num_hashes,
                             canonicalize, sig_sizes, row_offsets,
                             zero_row, packed_len)
    scores = _gather_count_planes(matrix, rows,
                                  num_hashes).reshape(rows.shape[0], -1)
    masked = _mask_scores(scores, valid_mask)
    vals, idx = jax.lax.top_k(masked, k)
    tier = _tier_pack(vals, idx, rows.shape[1], masked.shape[-1])
    return (*_shrink_topk(vals, idx, rows.shape[1], masked.shape[-1]),
            tier)


def prepack_query_bytes(index: DeviceIndex, qb: QueryBytes) -> None:
    """Run the host half of the query upload (pad to the jit bucket +
    optional 2-bit pack) ahead of dispatch, storing the result on the
    QueryBytes payload. Search's hashing stage calls this so the pack
    happens on the worker thread that search_stream overlaps with the
    device — the dispatch-side pack paths reuse it when present."""
    qbytes, lens, T_max = _pack_query_bytes(qb.queries,
                                            index.term_size)
    qbytes, packed_len = _maybe_pack_2bit(index, qbytes)
    qb.packed, qb.lens = qbytes, lens
    qb.t_max, qb.packed_len = T_max, packed_len


def _device_hash_args(index: DeviceIndex, qb: QueryBytes):
    if index.matrix.shape[0] > np.iinfo(np.int32).max:
        # same guard as the host path's row_indices — device hashing
        # must not silently truncate row ids
        raise ValueError("index too large for int32 row addressing")
    if qb.packed is None:
        prepack_query_bytes(index, qb)
    return (jnp.asarray(qb.packed), jnp.asarray(qb.lens), qb.t_max,
            tuple(int(s) for s in index.sig_sizes),
            tuple(int(o) for o in index.row_offsets), qb.packed_len)


def _maybe_pack_2bit(index: DeviceIndex, qbytes: np.ndarray):
    """(qdata, packed_len) with the 2-bit DNA pack applied if eligible.

    Validated ACGT packs 2 bits/base: another 4x off the upload (text
    mode hashes arbitrary bytes, so it ships them raw). Not measured on
    the H100 (PERF.md); COBS_TPU_PACK_QUERIES=0 ships raw bytes while
    keeping device hashing, for links where the pack/decode cost
    matters more than upload width. Accepts [..., L]
    (multi-batch callers pass [K, B, L])."""
    if index.canonicalize == 1 and os.environ.get(
            "COBS_TPU_PACK_QUERIES", "1") != "0":
        from cobs_tpu.ops.device_hash import pack_queries_2bit
        packed_len = qbytes.shape[-1]
        lead = qbytes.shape[:-1]
        packed = pack_queries_2bit(qbytes.reshape(-1, packed_len))
        return packed.reshape(*lead, packed.shape[-1]), packed_len
    return qbytes, 0


def score_batch_async(index: DeviceIndex,
                      hashes_list: "list[np.ndarray] | QueryBytes",
                      timer: Timer | None = None) -> PendingScores:
    """Dispatch the fused gather/AND/count without fetching.

    `hashes_list` is either per-query host hash tensors or a
    QueryBytes payload (device-side hashing). Returns a PendingScores
    whose fetch() yields the same int32 [B, counts_size] array as
    score_batch. At most a few of these should be in flight at once
    (each holds a [B, counts] device buffer).
    """
    if isinstance(hashes_list, QueryBytes):
        B = len(hashes_list)
        dq, dl, T_max, sigs, offs, plen = _device_hash_args(
            index, hashes_list)
        if timer:
            timer.active("io")
        with jax.enable_x64():  # XXH64 needs (emulated) uint64
            scores = _hash_gather_count(
                index.matrix, dq, dl, index.term_size,
                index.num_hashes, index.canonicalize, sigs, offs,
                index.zero_row, plen)
        scores = _shrink_scores(scores, T_max)
        if timer:
            timer.stop()
        return PendingScores(scores, B, index.doc_layout)
    B = len(hashes_list)
    B_pad = _bucket(B)
    T_max = _bucket(max(h.shape[0] for h in hashes_list))
    P = index.num_pages
    h = index.num_hashes

    rows_idx = np.full((B_pad, T_max, h, P), index.zero_row,
                       dtype=np.int32)
    for b, hs in enumerate(hashes_list):
        rows_idx[b, :hs.shape[0]] = index.row_indices(hs)
    if timer:
        timer.active("io")
    scores = _gather_and_count(index.matrix, jnp.asarray(rows_idx),
                               index.num_hashes)
    scores = _shrink_scores(scores, T_max)
    if timer:
        timer.stop()
    return PendingScores(scores, B, index.doc_layout)


def score_batch(index: DeviceIndex, hashes_list: list[np.ndarray],
                timer: Timer | None = None) -> np.ndarray:
    """Score a batch of queries against one index.

    Returns int32 [B, counts_size] in document order (page-major,
    page-local doc id = word*32 + bit), matching the reference's 8-aligned
    score layout (reference: cobs/query/classic_search.cpp:413-429).
    """
    # phase accounting: the gather/AND/count are one fused device
    # dispatch, timed as "io" (it is gather-bound); the host-side score
    # materialization (dtype restore + padding strip) is "add rows"
    pending = score_batch_async(index, hashes_list, timer)
    if timer:
        timer.active("add rows")
    out = pending.fetch()
    if timer:
        timer.stop()
    return out


class StreamedIndex:
    """Host-resident (memory-mapped) index backend.

    The analog of the reference's mmap search files
    (reference: cobs/query/classic_index/mmap_search_file.cpp:27-40,
    compact_index/mmap_search_file.cpp:34-67): the payload stays on disk
    and only the Bloom rows a query batch actually touches are read
    (through the OS page cache) and uploaded, so indexes far larger than
    device HBM remain queryable. The device still does the AND +
    popcount-accumulate on the gathered rows.
    """

    def __init__(self, path, drop_cache: bool = False):
        """drop_cache=True evicts the index's pages from the OS page
        cache after every scored batch (posix_fadvise DONTNEED), so each
        batch pays the true disk cost — the analog of the reference's
        O_DIRECT AIO backend's cold-cache behavior (reference:
        cobs/query/compact_index/aio_search_file.cpp:23-97)."""
        path = Path(path)
        self.path = str(path)
        self._drop_cache = drop_cache
        if fmt_classic.is_classic_file(path):
            with open(path, "rb") as f:
                h = fmt_classic.ClassicIndexHeader.deserialize(f)
                off = f.tell()
            payload_off = off
            self._payload_off = payload_off
            self.term_size = h.term_size
            self.canonicalize = h.canonicalize
            self.num_hashes = h.num_hashes
            self.page_size = h.row_size
            self.file_names = h.file_names
            self._row_bytes = h.row_size
            self._mms = [np.memmap(path, dtype=np.uint8, mode="r",
                                   offset=off,
                                   shape=(h.signature_size, h.row_size))]
            self.sig_sizes = np.asarray([h.signature_size],
                                        dtype=np.uint64)
        elif fmt_compact.is_compact_file(path):
            h, off = fmt_compact.read_compact_header(path)
            payload_off = off
            self._payload_off = payload_off
            if not h.parameters:
                raise FileIOError("compact index has no pages")
            num_hashes = h.parameters[0].num_hashes
            for p in h.parameters:
                if p.num_hashes != num_hashes:
                    raise FileIOError("compact index with non-uniform "
                                      "num_hashes unsupported")
            self.term_size = h.term_size
            self.canonicalize = h.canonicalize
            self.num_hashes = num_hashes
            self.page_size = h.page_size
            self.file_names = h.file_names
            self._row_bytes = h.page_size
            self._mms = []
            for p in h.parameters:
                self._mms.append(np.memmap(
                    path, dtype=np.uint8, mode="r", offset=off,
                    shape=(p.signature_size, h.page_size)))
                off += p.signature_size * h.page_size
            self.sig_sizes = np.asarray(
                [p.signature_size for p in h.parameters], dtype=np.uint64)
        else:
            raise FileIOError(f'Could not open index path "{path}"')
        self.word_width = _pad_words(-(-self._row_bytes // 4))
        offs = np.zeros(len(self._mms), dtype=np.int64)
        acc = 0
        for i, mm in enumerate(self._mms):
            offs[i] = acc
            acc += mm.shape[0]
        self.row_offsets = offs
        self.total_rows = acc
        # one contiguous view over all pages (they are back to back in
        # the file, all with the same row stride): what the native
        # host-scoring kernel indexes with global row ids
        self._payload = np.memmap(path, dtype=np.uint8, mode="r",
                                  offset=payload_off,
                                  shape=(acc, self._row_bytes))

    @property
    def num_pages(self) -> int:
        return len(self._mms)

    @property
    def docs_per_page(self) -> int:
        return 8 * self.page_size

    @property
    def counts_size(self) -> int:
        return 8 * self.page_size * self.num_pages

    @property
    def doc_layout(self) -> DocLayout:
        return _uniform_layout(self.num_pages, self.word_width,
                               self.docs_per_page)

    def row_indices(self, hashes: np.ndarray) -> np.ndarray:
        """uint64 [T, h] -> global row ids int64 [T, h, P]."""
        return (hashes[:, :, None] % self.sig_sizes[None, None, :]
                + self.row_offsets[None, None, :].astype(np.uint64)) \
            .astype(np.int64)

    def drop_cache(self) -> None:
        """Evict this index's payload from the OS page cache (no root
        needed, unlike the reference's /proc/sys/vm/drop_caches —
        reference: src/cobs.cpp:616-620); next access reads from disk."""
        import os

        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)

    def _host_score(self):
        """True when scoring should run in the native host kernel
        instead of uploading gathered rows to the device.

        The streamed regime reads ~|batch| * T * h * row_bytes of rows
        per batch; shipping them host->device costs at least as much
        traffic as the expansion-add work itself, so the native kernel
        (the analog of the reference's SSE2 expand loop, reference:
        cobs/query/classic_search.cpp:279-401) is the default whenever
        it is available. settings.streamed_host_score: "host" /
        "device" / "auto".
        """
        from cobs_tpu import native
        from cobs_tpu.settings import settings

        mode = str(settings.streamed_host_score).lower()
        if mode in ("device", "0", "false"):
            return False
        if mode in ("host", "1", "true"):
            if native.lib() is None:
                raise FileIOError(
                    "streamed_host_score=host but the native library "
                    "is unavailable")
            return True
        return native.lib() is not None

    def _rows_global(self, hashes_list):
        """int64 [B, T_max, h, P] global row ids; padding terms point
        at the virtual zero row (id == total_rows)."""
        B = len(hashes_list)
        T_max = max(h.shape[0] for h in hashes_list)
        P = self.num_pages
        h = self.num_hashes
        rows_idx = np.full((B, T_max, h, P), self.total_rows,
                           dtype=np.int64)
        for b, hs in enumerate(hashes_list):
            rows_idx[b, :hs.shape[0]] = self.row_indices(hs)
        return rows_idx

    def _score_batch_host(self, hashes_list, timer: Timer | None):
        """Fused gather/AND/expand-add in the native kernel, straight
        off the mmap'd payload (no device round trip).

        Cold-cache mode first pulls the batch's unique rows with a deep
        io_uring read queue (the analog of the reference's O_DIRECT AIO
        batch, reference: aio_search_file.cpp:23-97) and scores from
        the compact buffer: scattered disk reads complete concurrently
        instead of one synchronous page fault at a time per thread."""
        from cobs_tpu import native
        from cobs_tpu.settings import settings

        rows_idx = self._rows_global(hashes_list)
        payload, zero_id = self._payload, self.total_rows
        if self._drop_cache:
            if timer:
                timer.active("io")
            pulled = self._gather_unique_async(rows_idx)
            if pulled is not None:
                payload, rows_idx, zero_id = pulled
            if timer:
                timer.stop()
        if timer:
            timer.active("and rows")
        scores = native.score_batch_host(
            payload, self._row_bytes, rows_idx, zero_id,
            max(1, settings.threads))
        if timer:
            timer.stop()
        if scores is None:  # native vanished between check and call
            raise FileIOError("native host scoring unavailable")
        return scores

    def _gather_unique_async(self, rows_idx):
        """io_uring gather of the batch's unique rows into a compact
        buffer. Returns (buffer, remapped rows, zero row id) or None
        when io_uring is unavailable (callers keep the mmap path)."""
        from cobs_tpu import native

        uniq, inv = np.unique(rows_idx, return_inverse=True)
        n_real = int(np.searchsorted(uniq, self.total_rows))
        buf = np.zeros((n_real + 1, self._row_bytes), dtype=np.uint8)
        if not native.gather_rows_file(
                self.path, self._payload_off, self._row_bytes,
                uniq[:n_real], buf[:n_real],
                dontcache=self._drop_cache):
            return None
        # uniq is sorted, so a padding id (== total_rows) is last and
        # maps to index n_real — the buffer's zero row
        return buf, inv.reshape(rows_idx.shape).astype(np.int64), n_real

    def _prepare(self, hashes_list, timer: Timer | None):
        """Host stage: gather the touched rows, build remapped indices.

        Returns (gmat u32 [U_pad+1, W], remapped i32 [B_pad, T, h, P],
        T_max). U and B are padded to buckets so repeated batches reuse
        the compiled device program.
        """
        B_pad = _bucket(len(hashes_list))
        T_max = _bucket(max(h.shape[0] for h in hashes_list))
        P = self.num_pages
        h = self.num_hashes
        zero_id = self.total_rows  # virtual all-zero row

        rows_idx = np.full((B_pad, T_max, h, P), zero_id, dtype=np.int64)
        for b, hs in enumerate(hashes_list):
            rows_idx[b, :hs.shape[0]] = self.row_indices(hs)

        if timer:
            timer.active("io")
        uniq, inv = np.unique(rows_idx, return_inverse=True)
        W = self.word_width
        u_pad = _bucket(uniq.size)
        gathered = np.zeros((u_pad + 1, W * 4), dtype=np.uint8)
        n_real = int(np.searchsorted(uniq, zero_id))
        from cobs_tpu import native
        from cobs_tpu.settings import settings

        if n_real:
            real = uniq[:n_real].astype(np.int64)
            # cold mode: deep async io_uring read queue; warm: parallel
            # scattered reads through the OS page cache — both the
            # analog of the reference's AIO batch (reference:
            # cobs/query/compact_index/aio_search_file.cpp:23-97)
            if not (self._drop_cache and native.gather_rows_file(
                    self.path, self._payload_off, self._row_bytes,
                    real, gathered[:n_real], dontcache=True)):
                if not native.gather_rows(
                        self._payload, self._row_bytes, real,
                        gathered[:n_real], settings.threads):
                    gathered[:n_real, :self._row_bytes] = \
                        self._payload[real]
        # rows at/after the zero id (padding) stay 0
        gmat = jnp.asarray(
            np.ascontiguousarray(gathered).view("<u4"))
        remapped = inv.reshape(rows_idx.shape).astype(np.int32)
        if timer:
            timer.stop()
        return gmat, remapped, T_max

    def _pool(self):
        """Lazy single-worker executor for async host scoring (the
        native kernel is internally multithreaded; one worker keeps
        batches ordered and bounds memory)."""
        p = getattr(self, "_host_pool", None)
        if p is None:
            import concurrent.futures

            p = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="cobs-host-score")
            self._host_pool = p
        return p

    def _after_score(self):
        if not self._drop_cache:
            return None

        def evict():
            from cobs_tpu import native

            # RWF_DONTCACHE gathers never populate the cache, so the
            # per-batch eviction (which can only re-warm measurement
            # noise anyway) has nothing to do; the mmap fallback path
            # still needs it
            if native.dontcache_supported():
                return
            self.drop_cache()

        return evict

    def _host_topk(self, scores, k: int):
        """Vectorized host top-k with the engine contract: combined
        key (score desc, slot asc) matches lax.top_k's
        prefer-lower-index tie rule; -1 pads past the doc count."""
        B = scores.shape[0]
        n = len(self.file_names)
        kk = min(k, n)
        s = scores[:, :n].astype(np.int64)
        key = s * n - np.arange(n, dtype=np.int64)[None, :]
        if kk < n:
            cand = np.argpartition(-key, kk - 1, axis=1)[:, :kk]
        else:
            cand = np.broadcast_to(np.arange(n), (B, n)).copy()
        order = np.argsort(-np.take_along_axis(key, cand, axis=1),
                           axis=1, kind="stable")
        sel = np.take_along_axis(cand, order, axis=1)
        vals = np.full((B, k), -1, dtype=np.int32)
        docs = np.zeros((B, k), dtype=np.int64)
        vals[:, :kk] = np.take_along_axis(s, sel, axis=1)
        docs[:, :kk] = sel
        return vals, docs

    def score_batch_async(self, hashes_list,
                          timer: Timer | None = None):
        """Dispatch scoring without fetching; fetch() yields the
        score_batch contract. Host-scored batches run on a worker
        thread (no device traffic there); device batches dispatch from
        the calling thread and only the fetch blocks."""
        B = len(hashes_list)
        if self._host_score():
            wt = Timer()
            fut = self._pool().submit(
                self._score_batch_host, hashes_list, wt)
            return PendingHost(fut, self._after_score(), wt, timer)
        gmat, remapped, T_max = self._prepare(hashes_list, timer)
        if timer:
            timer.active("and rows")
        scores = _gather_and_count(gmat, jnp.asarray(remapped),
                                   self.num_hashes)
        scores = _shrink_scores(scores, T_max)
        if timer:
            timer.stop()
        return PendingScores(scores, B, self.doc_layout,
                             self._after_score())

    def score_batch(self, hashes_list, timer: Timer | None = None
                    ) -> np.ndarray:
        """int32 [B, counts_size]; exact same contract as score_batch."""
        if self._host_score():
            out = self._score_batch_host(hashes_list, timer)
            if self._drop_cache:
                self.drop_cache()
            return out
        pending = self.score_batch_async(hashes_list, timer)
        if timer:
            timer.active("add rows")
        out = pending.fetch()
        if timer:
            timer.stop()
        return out

    def score_topk_async(self, hashes_list, k: int,
                         timer: Timer | None = None):
        """Async top-k; fetch() yields the score_topk contract."""
        B = len(hashes_list)
        if self._host_score():
            wt = Timer()

            def work():
                return self._host_topk(
                    self._score_batch_host(hashes_list, wt), k)

            return PendingHost(self._pool().submit(work),
                               self._after_score(), wt, timer)
        gmat, remapped, _ = self._prepare(hashes_list, timer)
        mask = getattr(self, "_valid_mask_dev", None)
        if mask is None:
            mask = jax.device_put(_doc_valid_mask(
                self.doc_layout, len(self.file_names)))
            self._valid_mask_dev = mask
        if timer:
            timer.active("and rows")
        vals, idx, tier = _gather_count_topk(
            gmat, jnp.asarray(remapped), mask, self.num_hashes,
            min(k, int(mask.shape[0])))
        if timer:
            timer.stop()
        return PendingTopK(vals, idx, B, self.doc_layout,
                           self._after_score(), tier=tier)

    def score_topk(self, hashes_list, k: int,
                   timer: Timer | None = None):
        """Top-k scoring on the streamed backend; same contract as
        engine.score_topk (only [B, k] pairs cross from the device).

        With host scoring active there is no transfer to save; the
        top-k select runs on the host with the same (score desc,
        doc asc) tie order and -1 padding contract."""
        if self._host_score():
            scores = self._score_batch_host(hashes_list, timer)
            if self._drop_cache:
                self.drop_cache()
            return self._host_topk(scores, k)
        pending = self.score_topk_async(hashes_list, k, timer)
        if timer:
            timer.active("add rows")
        out = pending.fetch()
        if timer:
            timer.stop()
        return out


def _doc_valid_mask(lay: DocLayout, n_files: int) -> np.ndarray:
    """bool [P*W*32]: True for score slots of real documents (excludes
    per-page word padding — and each merged page's phantom tail on
    run-coalesced indexes — plus 8-alignment slots beyond the file
    count)."""
    W32 = lay.w32
    slots = np.arange(lay.num_pages * W32)
    page, local = slots // W32, slots % W32
    doc_number = lay.doc_offsets[page] + local
    return (local < lay.page_docs[page]) & (doc_number < n_files)



def _topk_mask(index) -> jax.Array:
    """The device-resident valid-slot mask for top-k, cached on the
    index. Deliberately FULL width (the padded slot count): truncating
    it to the last real slot made the top-k slower on the previous
    accelerator. Not yet measured on the H100."""
    mask = getattr(index, "_valid_mask", None)
    if mask is None:
        mask = jax.device_put(_doc_valid_mask(
            index.doc_layout, len(index.file_names)))
        index._valid_mask = mask
    return mask


def _mask_scores(scores, valid_mask):
    """[B, slots] scores with invalid slots forced to -1 (a prefix
    slice would also be legal here, see _topk_mask)."""
    n_keep = valid_mask.shape[0]
    if n_keep < scores.shape[1]:
        scores = scores[:, :n_keep]
    return jnp.where(valid_mask[None, :], scores, -1)


#: prefix-tier width for the threshold-compacted top-k fetch. At the
#: reference's default serving mode (-t 0.8 -l 100,
#: reference: src/cobs.cpp:486-489) nearly every query has far fewer
#: hits >= its score floor than k, so the [B, k] u16 pair fetch is
#: mostly padding (~400 B/query). Every top-k program also
#: emits a packed u32 [B, _TOPK_TIER] prefix of the same sorted rows;
#: the host fetches that (8x narrower) and escalates to the full
#: arrays only when some row's tier boundary still clears its floor.
_TOPK_TIER = 8

#: fetch-path counters (diagnostics/tests): how often the tier prefix
#: sufficed vs escalated to the full [B, k] fetch
_tier_counters = {"tier_fetches": 0, "full_fetches": 0}


def _tier_pack(vals, idx, t_pad: int, n_slots: int):
    """Packed u32 [.., _TOPK_TIER] prefix of the sorted top-k rows:
    (score+1) << 16 | slot. None when either half exceeds uint16
    (huge queries or indexes — the full fetch is then the only exact
    path) or k is already within the tier."""
    if (t_pad > 65534 or n_slots > 65535
            or vals.shape[-1] <= _TOPK_TIER):
        return None
    v = (vals[..., :_TOPK_TIER] + 1).astype(jnp.uint32)
    return (v << 16) | idx[..., :_TOPK_TIER].astype(jnp.uint32)


def _tier_unpack(packed: np.ndarray):
    """Host half of _tier_pack: (scores i32, slot ids i64)."""
    v = (packed >> 16).astype(np.int32) - 1
    i = (packed & 0xFFFF).astype(np.int64)
    return v, i


def _tier_sufficient(tier_vals: np.ndarray, lims, cap: int) -> bool:
    """True when every row's results provably fit the [B, TIER] tier
    prefix: row b consumes at most min(cap, hits_b) leading entries,
    and rows sort score-descending, so a tier whose LAST score is
    already below the row's floor contains the whole hit prefix."""
    if cap and cap <= tier_vals.shape[-1]:
        # defensive: callers currently dispatch k == cap, and a tier is
        # only emitted for k > _TOPK_TIER, so this fires only if a
        # future caller decouples the ranked cap from the dispatched k
        return True
    lims = np.asarray(lims)[:tier_vals.shape[0]]
    return not np.any(tier_vals[:, -1] >= lims)


def _shrink_topk(vals, idx, t_pad: int, n_slots: int):
    """Narrow the top-k fetch for the device-to-host link.

    vals are in [-1, t_pad] (-1 = masked padding slot), shipped +1 as
    uint16 whenever the padded term count allows; slot ids fit uint16
    whenever the padded slot count does: the naive i32+i32 [B, k]
    fetch is 800 B/query at k=100, uint16 ships 4x less.
    PendingTopK/PendingTopKView restore int32-1
    on the host — bit-exact round trip, the top-k analog of
    _shrink_scores (the reference's score-width tiering, reference:
    cobs/query/classic_search.cpp:453-500)."""
    if t_pad <= 65534:
        vals = (vals + 1).astype(jnp.uint16)
    if n_slots <= 65535:
        idx = idx.astype(jnp.uint16)
    return vals, idx


def _unshrink_topk_vals(vals: np.ndarray) -> np.ndarray:
    """Host half of _shrink_topk: restore the int32 [-1, T] contract."""
    if vals.dtype == np.uint16:
        return vals.astype(np.int32) - 1
    return vals


@functools.partial(jax.jit, static_argnames=("num_hashes", "k"))
def _gather_count_topk(matrix, rows_idx, valid_mask, num_hashes, k):
    scores = _gather_and_count(matrix, rows_idx, num_hashes)
    masked = _mask_scores(scores, valid_mask)
    vals, idx = jax.lax.top_k(masked, k)
    tier = _tier_pack(vals, idx, rows_idx.shape[1], masked.shape[-1])
    return (*_shrink_topk(vals, idx, rows_idx.shape[1],
                          masked.shape[-1]), tier)


def score_topk_async(index: DeviceIndex, hashes_list, k: int,
                     timer: Timer | None = None) -> PendingTopK:
    """Dispatch top-k scoring without fetching; fetch() yields the
    score_topk contract (hashes_list may be a QueryBytes payload for
    device-side hashing). Same in-flight discipline as
    score_batch_async."""
    mask0 = _topk_mask(index)
    if isinstance(hashes_list, QueryBytes):
        B = len(hashes_list)
        dq, dl, T_max, sigs, offs, plen = _device_hash_args(
            index, hashes_list)
        if timer:
            timer.active("io")
        with jax.enable_x64():  # XXH64 needs (emulated) uint64
            vals, idx, tier = _hash_gather_count_topk(
                index.matrix, dq, dl, mask0, index.term_size,
                index.num_hashes, index.canonicalize, sigs, offs,
                index.zero_row, min(k, int(mask0.shape[0])), plen)
        if timer:
            timer.stop()
        return PendingTopK(vals, idx, B, index.doc_layout,
                           tier=tier)
    B = len(hashes_list)
    B_pad = _bucket(B)
    T_max = _bucket(max(h.shape[0] for h in hashes_list))
    P = index.num_pages
    h = index.num_hashes
    rows_idx = np.full((B_pad, T_max, h, P), index.zero_row,
                       dtype=np.int32)
    for b, hs in enumerate(hashes_list):
        rows_idx[b, :hs.shape[0]] = index.row_indices(hs)

    mask = mask0  # built above, before the QueryBytes branch

    if timer:
        timer.active("io")
    vals, idx, tier = _gather_count_topk(
        index.matrix, jnp.asarray(rows_idx), mask, index.num_hashes,
        min(k, int(mask.shape[0])))
    if timer:
        timer.stop()
    return PendingTopK(vals, idx, B, index.doc_layout, tier=tier)


def score_topk(index: DeviceIndex, hashes_list, k: int,
               timer: Timer | None = None):
    """Top-k scoring: only [B, k] (score, document) pairs cross the
    device-to-host link instead of the full per-document score vector.

    `lax.top_k` prefers lower indices on ties, which is exactly the
    reference's (score desc, doc asc) result order (reference:
    cobs/query/classic_search.cpp:140-144). Padding slots (page word
    padding and 8-alignment beyond the real document count) are masked
    to -1 so they sort last; callers must drop negative scores.

    Returns (scores i32 [B, k], doc_numbers i64 [B, k]) where
    doc_number = page * docs_per_page + page-local id, i.e. the same
    score-slot numbering as score_batch's output.
    """
    pending = score_topk_async(index, hashes_list, k, timer)
    if timer:
        timer.active("io")
    out = pending.fetch()
    if timer:
        timer.stop()
    return out


# --------------------------------------------------------------------
# Multi-batch mega-dispatch: K query batches inside ONE device program.
#
# Every dispatch+fetch pays a fixed cost beside the device time of a
# batch. This section amortizes it on the PRODUCTION path: a lax.scan
# over K stacked batches — per-step batch size stays at the serving
# batch while the dispatch+fetch cost divides by K. Whether it pays on
# the H100 is not yet measured (PERF.md).
# The reference's serial query loop being beaten:
# (reference: src/cobs.cpp:471-527).
# --------------------------------------------------------------------


_UNFETCHED = object()


class _SharedFetch:
    """One device-to-host materialization shared by the K per-batch
    pending handles of a mega-dispatch (the first fetch blocks on the
    whole program; the rest are free). Arrays fetch LAZILY per slot:
    the tier-compacted top-k path reads only the narrow prefix array
    unless some batch escalates to the full candidates."""

    __slots__ = ("_dev", "_host")

    def __init__(self, *dev):
        self._dev = list(dev)
        self._host = [_UNFETCHED] * len(dev)

    def get(self) -> tuple:
        return tuple(self.get_one(i) for i in range(len(self._host)))

    def get_one(self, i: int):
        if self._host[i] is _UNFETCHED:
            a = self._dev[i]
            self._host[i] = (None if a is None else
                             np.asarray(jax.block_until_ready(a)))
            self._dev[i] = None
        return self._host[i]


class PendingScoresView:
    """PendingScores over one batch slice of a mega-dispatch."""

    __slots__ = ("_shared", "_g", "_B", "_lay")

    def __init__(self, shared, g, B, layout: DocLayout):
        self._shared = shared
        self._g = g
        self._B = B
        self._lay = layout

    def fetch(self) -> np.ndarray:
        scores = self._shared.get()[0][self._g][:self._B]
        return _strip_word_padding(scores, self._B, self._lay)


class PendingTopKView:
    """PendingTopK over one batch slice of a mega-dispatch."""

    __slots__ = ("_shared", "_g", "_B", "_lay")

    def __init__(self, shared, g, B, layout: DocLayout):
        self._shared = shared
        self._g = g
        self._B = B
        self._lay = layout

    def fetch(self):
        vals = self._shared.get_one(0)
        idx = self._shared.get_one(1)
        v = _unshrink_topk_vals(vals[self._g][:self._B])
        docs = _slot_doc_numbers(idx[self._g][:self._B], self._lay)
        return v, docs

    def fetch_topk(self, lims, cap: int):
        """Tier-compacted fetch over this view's batch slice (see
        PendingTopK.fetch_topk); the [K, B, TIER] prefix array is
        shared, so one narrow transfer serves the whole mega group."""
        tier = self._shared.get_one(2)
        if tier is None:
            return self.fetch()
        v, i = _tier_unpack(tier[self._g][:self._B])
        if not _tier_sufficient(v, lims, cap):
            _tier_counters["full_fetches"] += 1
            return self.fetch()
        _tier_counters["tier_fetches"] += 1
        docs = _slot_doc_numbers(i, self._lay)
        return v, docs


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8, 9))
def _hash_gather_count_multi(matrix, qdata, qlens, term_size,
                             num_hashes, canonicalize, sig_sizes,
                             row_offsets, zero_row, packed_len):
    """Device-hash full-rank scoring of K stacked batches:
    qdata [K, B, Lp], qlens [K, B] -> scores [K, B, P*W*32]."""
    from cobs_tpu.ops.device_hash import rows_from_queries

    def body(c, xs):
        qd, ql = xs
        rows = rows_from_queries(qd, ql, term_size, num_hashes,
                                 canonicalize, sig_sizes, row_offsets,
                                 zero_row, packed_len)
        return c, _gather_count_planes(matrix, rows, num_hashes) \
            .reshape(rows.shape[0], -1)

    _, scores = lax.scan(body, 0, (qdata, qlens))
    return scores


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10, 11))
def _hash_gather_count_topk_multi(matrix, qdata, qlens, valid_mask,
                                  term_size, num_hashes, canonicalize,
                                  sig_sizes, row_offsets, zero_row, k,
                                  packed_len):
    """Device-hash top-k of K stacked batches -> ([K, B, k], [K, B, k])."""
    from cobs_tpu.ops.device_hash import rows_from_queries

    def body(c, xs):
        qd, ql = xs
        rows = rows_from_queries(qd, ql, term_size, num_hashes,
                                 canonicalize, sig_sizes, row_offsets,
                                 zero_row, packed_len)
        scores = _gather_count_planes(matrix, rows, num_hashes) \
            .reshape(rows.shape[0], -1)
        masked = _mask_scores(scores, valid_mask)
        v, i = jax.lax.top_k(masked, k)
        tier = _tier_pack(v, i, rows.shape[1], masked.shape[-1])
        return c, (*_shrink_topk(v, i, rows.shape[1],
                                 masked.shape[-1]), tier)

    _, (vals, idx, tier) = lax.scan(body, 0, (qdata, qlens))
    return vals, idx, tier


@functools.partial(jax.jit, static_argnames=("num_hashes",))
def _gather_and_count_multi(matrix, rows_idx, num_hashes):
    """Host-hash full-rank scoring of K stacked row-id batches:
    rows_idx [K, B, T, h, P] -> scores [K, B, P*W*32]."""

    def body(c, idx):
        return c, _gather_count_planes(matrix, idx, num_hashes) \
            .reshape(idx.shape[0], -1)

    _, scores = lax.scan(body, 0, rows_idx)
    return scores


@functools.partial(jax.jit, static_argnames=("num_hashes", "k"))
def _gather_count_topk_multi(matrix, rows_idx, valid_mask, num_hashes,
                             k):
    def body(c, idx):
        scores = _gather_count_planes(matrix, idx, num_hashes) \
            .reshape(idx.shape[0], -1)
        masked = _mask_scores(scores, valid_mask)
        v, i = jax.lax.top_k(masked, k)
        tier = _tier_pack(v, i, idx.shape[1], masked.shape[-1])
        return c, (*_shrink_topk(v, i, idx.shape[1],
                                 masked.shape[-1]), tier)

    _, (vals, idx, tier) = lax.scan(body, 0, rows_idx)
    return vals, idx, tier


def _multi_query_args(index: DeviceIndex, payloads: list):
    """Stack K QueryBytes payloads to common-shape device inputs:
    (qdata [K, B, *], qlens [K, B], T_max, sigs, offs, packed_len)."""
    if index.matrix.shape[0] > np.iinfo(np.int32).max:
        raise ValueError("index too large for int32 row addressing")
    sigs = tuple(int(s) for s in index.sig_sizes)
    offs = tuple(int(o) for o in index.row_offsets)
    # prepacked fast path: when every payload was packed ahead (worker
    # thread, prepack_query_bytes) to the SAME shapes — the serving
    # common case of uniform-length batches — the group is one stack
    # instead of a refill+repack on the dispatch critical path
    shapes = {(p.packed.shape, p.t_max, p.packed_len)
              for p in payloads if p.packed is not None}
    if len(shapes) == 1 and all(p.packed is not None
                                for p in payloads):
        qb = np.stack([p.packed for p in payloads])
        lens = np.stack([p.lens for p in payloads])
        return (jnp.asarray(qb), jnp.asarray(lens),
                payloads[0].t_max, sigs, offs,
                payloads[0].packed_len)
    k = index.term_size
    B_pad = _bucket(max(len(p) for p in payloads))
    T_max = _bucket(max(len(q) for p in payloads for q in p.queries)
                    - k + 1)
    L_pad = T_max + k - 1
    qb = np.full((len(payloads), B_pad, L_pad), ord("A"),
                 dtype=np.uint8)
    lens = np.zeros((len(payloads), B_pad), dtype=np.int32)
    for g, p in enumerate(payloads):
        _fill_query_rows(qb[g], lens[g], p.queries)
    qb, packed_len = _maybe_pack_2bit(index, qb)
    return (jnp.asarray(qb), jnp.asarray(lens), T_max, sigs, offs,
            packed_len)


def _multi_rows_idx(index: DeviceIndex, payloads: list):
    """Stack K host-hash batches to rows_idx [K, B, T, h, P] + T_max."""
    B_pad = _bucket(max(len(p) for p in payloads))
    T_max = _bucket(max(h.shape[0] for p in payloads for h in p))
    P, nh = index.num_pages, index.num_hashes
    rows = np.full((len(payloads), B_pad, T_max, nh, P),
                   index.zero_row, dtype=np.int32)
    for g, p in enumerate(payloads):
        for b, hs in enumerate(p):
            rows[g, b, :hs.shape[0]] = index.row_indices(hs)
    return rows, T_max


def score_batch_multi_async(index: DeviceIndex, payloads: list,
                            timer: Timer | None = None) -> list:
    """Dispatch K query batches as ONE device program (full ranking).

    `payloads` is a list of K batches — each a QueryBytes or a list of
    per-query hash tensors, uniformly — all scored by a single
    lax.scan program whose per-step batch keeps the in-dispatch sweet
    spot. Returns K pending handles with the exact PendingScores
    contract; the first fetch blocks on the whole program, the rest
    are free. Distinct K values compile distinct programs — callers
    should stick to a small ladder (Search buckets to powers of two).
    """
    if timer:
        timer.active("io")
    if payloads and isinstance(payloads[0], QueryBytes):
        dq, dl, T_max, sigs, offs, plen = _multi_query_args(index,
                                                            payloads)
        with jax.enable_x64():  # XXH64 needs (emulated) uint64
            scores = _hash_gather_count_multi(
                index.matrix, dq, dl, index.term_size,
                index.num_hashes, index.canonicalize, sigs, offs,
                index.zero_row, plen)
    else:
        rows, T_max = _multi_rows_idx(index, payloads)
        scores = _gather_and_count_multi(index.matrix,
                                         jnp.asarray(rows),
                                         index.num_hashes)
    scores = _shrink_scores(scores, T_max)
    if timer:
        timer.stop()
    shared = _SharedFetch(scores)
    lay = index.doc_layout
    return [PendingScoresView(shared, g, len(p), lay)
            for g, p in enumerate(payloads)]


def score_topk_multi_async(index: DeviceIndex, payloads: list, k: int,
                           timer: Timer | None = None) -> list:
    """Dispatch K query batches as ONE device top-k program.

    Same contract per handle as PendingTopK; same K-program discipline
    as score_batch_multi_async.
    """
    mask = _topk_mask(index)
    k_eff = min(k, int(mask.shape[0]))
    if timer:
        timer.active("io")
    if payloads and isinstance(payloads[0], QueryBytes):
        dq, dl, _, sigs, offs, plen = _multi_query_args(index,
                                                        payloads)
        with jax.enable_x64():
            vals, idx, tier = _hash_gather_count_topk_multi(
                index.matrix, dq, dl, mask, index.term_size,
                index.num_hashes, index.canonicalize, sigs, offs,
                index.zero_row, k_eff, plen)
    else:
        rows, _ = _multi_rows_idx(index, payloads)
        vals, idx, tier = _gather_count_topk_multi(
            index.matrix, jnp.asarray(rows), mask, index.num_hashes,
            k_eff)
    if timer:
        timer.stop()
    shared = _SharedFetch(vals, idx, tier)
    lay = index.doc_layout
    return [PendingTopKView(shared, g, len(p), lay)
            for g, p in enumerate(payloads)]
