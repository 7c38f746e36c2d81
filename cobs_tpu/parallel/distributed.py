"""Multi-host deployment: process-group init + global mesh.

The reference is strictly single-node (pthread pool + mmap, no network
layer — reference: cobs/util/parallel_for.hpp:24-63); scaling beyond one
host is a capability this framework introduces. The recipe:

1. every host calls :func:`initialize` (JAX's distributed runtime —
   coordinator handshake, global device visibility);
2. :func:`global_mesh` builds the ("batch", "docs") mesh over ALL
   devices in the job; the signature matrix is sharded on "docs" with
   `NamedSharding`, so each host's chips hold their documents' columns
   in HBM and XLA places the (single, tiny) score assembly all-gather
   on ICI within a slice / DCN across slices;
3. construction stays host-local: each host builds the classic batches
   for its own document range (the batch files double as checkpoints,
   reference: cobs/construction/classic_index.cpp:173-174), and the
   per-host sub-indices federate at query time exactly like the
   reference's multi-index search.

Queries are broadcast (replicated spec) — they are KB-scale against a
GB-scale matrix, so replication is the right trade.
"""

from pathlib import Path

import jax

from cobs_tpu.parallel.sharded import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the JAX distributed runtime (no-op if single-process).

    Mirrors `jax.distributed.initialize`; where JAX detects the cluster
    the arguments may be omitted, elsewhere give all three (one host:
    coordinator_address="localhost:<port>").
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def global_mesh(n_batch: int = 1):
    """("batch", "docs") mesh over every device in the (multi-host) job.

    Use the result as `Search(..., mesh=global_mesh())` — the identical
    shard_map program runs single-host and multi-host.
    """
    return make_mesh(n_batch=n_batch, devices=jax.devices())


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def barrier(name: str = "cobs") -> None:
    """Cross-process sync point (no-op single-process)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def partition_documents(doc_list, num_processes: int, process_id: int,
                        by_size: bool = False, align: int = 8):
    """Deterministic contiguous document slice for one process.

    The list is sorted (by path, or by size for compact construction so
    pages stay size-coherent) and split into `num_processes` contiguous
    chunks rounded up to `align` documents. The default 8 is the octet
    alignment the batch machinery uses (reference:
    classic_index.cpp:143-148), so a shard boundary never splits a byte
    column; compact construction passes align = 8*page_size so a shard
    boundary never splits a PAGE either — each shard's pages are then
    exactly the pages a single-process build would form, which is what
    makes federated compact scores bit-identical (see construct()).
    """
    from cobs_tpu.ingest.document_list import DocumentList

    entries = list(doc_list.list())
    entries.sort(key=(lambda e: (e.size, e.path)) if by_size
                 else (lambda e: e.path))
    chunk = -(-len(entries) // max(1, num_processes))
    chunk = max(align, -(-chunk // align) * align)
    lo = min(process_id * chunk, len(entries))
    hi = min(lo + chunk, len(entries))
    part = DocumentList(entries=entries[lo:hi])
    if by_size:
        part.sort_by_size()
    return part


def shard_path(out_prefix, process_id: int, kind: str = "classic"):
    from cobs_tpu.fmt import classic as fmt_classic
    from cobs_tpu.fmt import compact as fmt_compact

    ext = (fmt_classic.FILE_EXTENSION if kind == "classic"
           else fmt_compact.FILE_EXTENSION)
    return Path(f"{out_prefix}.shard{process_id:04d}{ext}")


def shard_paths(out_prefix, num_processes: int | None = None,
                kind: str = "classic") -> list:
    if num_processes is None:
        num_processes = process_count()
    return [shard_path(out_prefix, i, kind)
            for i in range(num_processes)]


def construct(doc_list, out_prefix, kind: str = "classic",
              index_params=None, tmp_path=None,
              num_processes: int | None = None,
              process_id: int | None = None):
    """Multi-host construction driver: this process builds the index
    shard for its own document slice.

    The document axis is partitioned deterministically across processes
    (every host computes the same partition from the same list — no
    coordination traffic); each host runs the ordinary single-host
    construction over its slice, writing `<out_prefix>.shardNNNN.<ext>`
    on the shared filesystem. The per-shard batch files double as
    checkpoints exactly like single-host construction (reference
    machinery being scaled: cobs/construction/classic_index.cpp:143-189
    batch splitting; resume semantics cpp:173-174). Query-time
    federation over the shards is the reference's multi-index search
    (reference: cobs/query/classic_search.cpp:413-435) — open with
    :func:`open_federated`.

    For classic indices the Bloom signature size is computed ONCE from
    the global largest document, so every shard shares the geometry a
    single-host build would use and federated scores are bit-identical
    to the single-index build. Compact shards fit their own pages to
    their slice (the point of compact), partitioned in global size
    order so pages stay size-coherent.

    Returns this process's shard path.
    """
    if num_processes is None:
        num_processes = process_count()
    if process_id is None:
        process_id = process_index()

    out = shard_path(out_prefix, process_id, kind)
    if kind == "classic":
        from cobs_tpu.construct.classic import (
            ClassicIndexParameters,
            _classic_construct_sized,
            calc_signature_size,
            get_max_file_size,
        )

        params = index_params or ClassicIndexParameters()
        if params.num_hashes == 0:
            raise ValueError("num_hashes must not be zero")
        if params.signature_size != 0:
            raise ValueError("signature_size is computed, must be zero")
        part = partition_documents(doc_list, num_processes, process_id)
        # global geometry: size from the global largest document
        max_doc = get_max_file_size(doc_list, params.term_size)
        params = ClassicIndexParameters(**{
            **params.__dict__,
            "signature_size": calc_signature_size(
                max_doc, params.num_hashes,
                params.false_positive_rate)})
        if len(part) == 0:
            raise ValueError(
                f"process {process_id} has no documents: corpus of "
                f"{len(doc_list)} over {num_processes} processes")
        _classic_construct_sized(part, out, tmp_path, params)
    elif kind == "compact":
        import dataclasses

        from cobs_tpu.construct.compact import (
            compact_construct,
            default_page_size,
        )
        from cobs_tpu.construct.params import CompactIndexParameters

        params = index_params or CompactIndexParameters()
        # global geometry: the page size a single-process build over the
        # WHOLE corpus would pick (reference: compact_index.cpp:184-189),
        # and shard boundaries on multiples of 8*page_size documents in
        # global size order — every shard's pages (doc groups, fitted
        # Bloom sizes, zero-padding placement) are then exactly the
        # single build's pages, so federated (doc, score) results are
        # bit-identical to it, FP noise included
        # (tests/test_multihost_construct.py).
        page_size = params.page_size
        if page_size == 0:
            page_size = default_page_size(len(doc_list))
            params = dataclasses.replace(params, page_size=page_size)
        part = partition_documents(doc_list, num_processes, process_id,
                                   by_size=True, align=8 * page_size)
        if len(part) == 0:
            raise ValueError(
                f"process {process_id} has no documents: corpus of "
                f"{len(doc_list)} over {num_processes} processes is "
                f"fewer than one {8 * page_size}-document page per "
                "process — use a smaller page_size or fewer processes")
        compact_construct(part, out, tmp_path=tmp_path,
                          index_params=params)
    else:
        raise ValueError(f"unknown index kind {kind!r}")
    return out


def open_federated(out_prefix, num_processes: int | None = None,
                   kind: str = "classic", mesh=None, streamed=None):
    """Open every process's shard as one federated Search.

    All shards must be visible on this host's filesystem (shared
    storage across hosts). With `mesh` (e.g. :func:`global_mesh`) each shard
    is document-sharded over the mesh and scored with the shard_map
    engine; cross-process score fetches replicate automatically.
    """
    from cobs_tpu.query.search import Search

    paths = shard_paths(out_prefix, num_processes, kind)
    missing = [p for p in paths if not p.is_file()]
    if missing:
        raise FileNotFoundError(
            f"missing index shards (construction incomplete?): "
            f"{[str(p) for p in missing]}")
    return Search([str(p) for p in paths], mesh=mesh, streamed=streamed)
