"""Device-side classic-index construction.

The host path scatters Bloom bits with native C++ threads
(construct/bitmatrix.py). This module is the device equivalent the
SURVEY build plan calls for (§7 step 7): documents are hashed on the
host (native streaming kernels), the bit-set updates are uploaded in
fixed-size chunks, and the signature matrix is built on the device as a
document-sharded **byte-per-document indicator plane**:

    plane u8 [signature_size + 1, docs_pad]   (last row = scratch)

Scatter-set of an indicator is idempotent, so duplicate (row, doc)
updates — frequent, documents repeat k-mers — need no dedup pass, and
padding updates are routed to the scratch row. After the last update
the plane is bit-packed on device into little-endian uint32 words whose
byte layout equals the `.cobs_classic` payload (LSB-first bit = doc
index, reference: cobs/construction/classic_index.cpp:40-43), so the
fetched bytes are **bit-identical** to the host path's output.

On a ("batch", "docs") mesh the plane's document axis is sharded across
chips (tensor parallelism for construction); updates are replicated and
each shard keeps the ones that fall into its slice. Single-device is
the no-mesh special case of the same math.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cobs_tpu.construct.bitmatrix import doc_row_indices

#: updates per scatter dispatch (fixed shape -> one compiled program)
UPDATE_CHUNK = 1 << 20


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_single(plane, rows, docs):
    return plane.at[rows, docs].set(jnp.uint8(1), mode="drop")


@functools.lru_cache(maxsize=None)
def _make_scatter_sharded(mesh: Mesh):
    """One jitted sharded scatter per mesh: a fresh jit per call would
    re-trace (and re-compile)
    for every construction batch."""
    def local(plane, rows, docs):
        R1, Dl = plane.shape
        d0 = lax.axis_index("docs") * Dl
        d = docs - d0
        valid = (d >= 0) & (d < Dl)
        # foreign/padding updates are routed to the scratch row
        r = jnp.where(valid, rows, R1 - 1)
        d = jnp.where(valid, d, 0)
        return plane.at[r, d].set(jnp.uint8(1), mode="drop")

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "docs"), P(None), P(None)),
        out_specs=P(None, "docs"))
    return jax.jit(fn, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def _make_plane_init(mesh: Mesh | None):
    """Jitted on-device zero-plane allocator, cached per mesh (shapes
    are static args, so every batch reuses one compiled program per
    shape instead of re-tracing a fresh lambda)."""
    if mesh is None:
        return jax.jit(lambda R1, D: jnp.zeros((R1, D), jnp.uint8),
                       static_argnums=(0, 1))
    sharding = NamedSharding(mesh, P(None, "docs"))
    return jax.jit(lambda R1, D: jnp.zeros((R1, D), jnp.uint8),
                   static_argnums=(0, 1), out_shardings=sharding)


@jax.jit
def _pack_plane(plane):
    """u8 indicator [R1, D] -> u32 words [R1, D//32]; bit d%32 of word
    d//32 is document d (little-endian words == LSB-first bytes)."""
    R1, D = plane.shape
    bits = plane.reshape(R1, D // 32, 32).astype(jnp.uint32)
    return jnp.sum(bits << jnp.arange(32, dtype=jnp.uint32), axis=-1,
                   dtype=jnp.uint32)


def plane_bytes(signature_size: int, num_docs: int,
                mesh: Mesh | None = None) -> int:
    """HBM footprint of the construction plane for a batch."""
    shards = mesh.shape["docs"] if mesh is not None else 1
    return (signature_size + 1) * _round_up(max(num_docs, 1), 32 * shards)


def build_batch_matrix_device(entries, signature_size: int, row_size: int,
                              term_size: int, num_hashes: int,
                              canonicalize: int, warn,
                              mesh: Mesh | None = None) -> np.ndarray:
    """Device construction of one batch's bit matrix.

    Same contract and bit-identical output as
    bitmatrix.build_batch_matrix (reference pipeline being matched:
    cobs/construction/classic_index.cpp:36-189); the scatter runs on
    the device (sharded across `mesh` when given) instead of in native
    host threads. Returns uint8 [signature_size, row_size].
    """
    if signature_size + 1 > np.iinfo(np.int32).max:
        raise ValueError("signature too large for device construction")
    R1 = signature_size + 1
    shards = mesh.shape["docs"] if mesh is not None else 1
    D_pad = _round_up(max(row_size * 8, 1), 32 * shards)

    plane = _make_plane_init(mesh)(R1, D_pad)
    scatter = (_make_scatter_sharded(mesh) if mesh is not None
               else _scatter_single)

    def fresh_bufs():
        return (np.full(UPDATE_CHUNK, R1 - 1, dtype=np.int32),
                np.zeros(UPDATE_CHUNK, dtype=np.int32))

    buf_rows, buf_docs = fresh_bufs()
    fill = 0

    def flush():
        # fresh buffers every dispatch: jnp.asarray may alias the host
        # memory (zero-copy on the CPU backend), so refilling the same
        # arrays would race the asynchronous scatter
        nonlocal plane, buf_rows, buf_docs, fill
        plane = scatter(plane, jnp.asarray(buf_rows),
                        jnp.asarray(buf_docs))
        buf_rows, buf_docs = fresh_bufs()
        fill = 0

    for doc_index, entry in enumerate(entries):
        shown_warning = False
        for windows in entry.term_windows(term_size):
            rows, good = doc_row_indices(
                windows, signature_size, num_hashes, canonicalize)
            if not good and not shown_warning:
                warn(f"WARNING: Invalid DNA base pair (not ACGT) "
                     f"in document: {entry.path}")
                shown_warning = True
            rows = rows.astype(np.int32, copy=False)
            pos = 0
            while pos < rows.size:
                take = min(UPDATE_CHUNK - fill, rows.size - pos)
                buf_rows[fill:fill + take] = rows[pos:pos + take]
                buf_docs[fill:fill + take] = doc_index
                fill += take
                pos += take
                if fill == UPDATE_CHUNK:
                    flush()
    if fill:
        flush()

    words = np.asarray(_pack_plane(plane)[:signature_size])
    data = np.ascontiguousarray(words).view(np.uint8) \
        .reshape(signature_size, -1)[:, :row_size]
    return np.ascontiguousarray(data)
