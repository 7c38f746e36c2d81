"""Global runtime settings.

Mirrors the reference's global option set (reference: cobs/settings.hpp:16-23):
worker thread count, load-complete-index toggle, and document index cache
disable. Thread count drives the host-side parallel ingest pool; device-side
parallelism is controlled by the JAX mesh instead.
"""

import dataclasses
import os
from pathlib import Path

#: persistent XLA compilation cache when JAX_COMPILATION_CACHE_DIR is
#: unset: a fixed directory inside the checkout (git-ignored), because
#: the path is part of the cache key
COMPILE_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

#: device-resident index budget where the backend reports no memory
#: limit (the CPU backend)
DEFAULT_DEVICE_INDEX_BYTES = 8 << 30

#: device memory kept free beside a resident index, at least: the
#: scoring programs' gathered term chunks (engine._GATHER_BYTES_BUDGET,
#: 1 GiB), the [B, slots] score buffers of the batches in flight and the
#: full-rank mega-dispatch groups (search._MEGA_FULLRANK_BYTES each)
DEVICE_HEADROOM_BYTES = 4 << 30


@dataclasses.dataclass
class Settings:
    #! number of host worker threads (ingest / IO); 0 = os.cpu_count()
    threads: int = os.cpu_count() or 1
    #! load the complete index into device memory (vs. stream from host)
    load_complete_index: bool = False
    #! disable creation of .cobs_cache document index caches
    disable_cache: bool = False
    #! indices whose device footprint exceeds this stream from host mmap
    #! instead of residing in device memory; None = derived from the
    #! device's memory limit (device_index_budget)
    max_device_index_bytes: int | None = None
    #! mesh for device-side construction (None = all devices on the
    #! docs axis when more than one device is present)
    construct_mesh: object = None
    #! sequence-parallel threshold: a mesh-sharded query whose term
    #! count reaches this is split across the "batch" mesh axis
    #! (score_seq_sharded + psum) — SURVEY §5's long-context mapping.
    #! Terms per query are L - k + 1, so this triggers for ~64 kb+
    #! sequences by default.
    seq_split_terms: int = int(os.environ.get(
        "COBS_TPU_SEQ_SPLIT_TERMS", 1 << 16))
    #! where the streamed (host-mmap) backend scores gathered rows:
    #! "host" = native expansion-add kernel, "device" = upload + device
    #! gather/count, "auto" = host when the native library is available
    #! (the rows touched per batch rival the score work itself, so
    #! paying a host->device upload per batch usually loses)
    streamed_host_score: str = os.environ.get(
        "COBS_TPU_STREAMED_SCORE", "auto")
    #! where query hashing runs for device-resident matrices
    #! (DeviceIndex backends and mesh-sharded search): "auto"/"device"
    #! = inside the scoring program (upload raw query bytes — ~4x less
    #! H2D/broadcast than precomputed row indices — and hash/
    #! canonicalize/mod on device, ops/device_hash), "host" = the
    #! native host pipeline. Streamed (host-scored) backends and the
    #! sequence-parallel long-query split always hash on the host.
    device_hash: str = os.environ.get("COBS_TPU_DEVICE_HASH", "auto")
    #! multi-batch mega-dispatch ceiling: when a serving queue or query
    #! stream is deep, up to this many batches pack into ONE device
    #! program (lax.scan over stacked batches), amortizing the fixed
    #! per-dispatch+fetch cost. Groups round to powers of two to bound
    #! compiled-program count; 1 disables. Applies to plain DeviceIndex
    #! backends (device-resident, the dispatch-bound regime).
    mega_batches: int = int(os.environ.get("COBS_TPU_MEGA_BATCHES",
                                           "16"))
    #! batches the hashing worker prepares AHEAD of the serving loop's
    #! dispatcher (search_stream). 1 = hash exactly one batch ahead:
    #! the submit-after-result handoff then serializes the worker with
    #! the main thread's consume step. Cost: one raw query batch (~1 MB
    #! at B=1024) per slot. Not yet swept on the H100 (PERF.md).
    hash_ahead: int = int(os.environ.get("COBS_TPU_HASH_AHEAD", "4"))
    #! mega-dispatch groups kept in flight (dispatched-ahead) by
    #! search_stream before it blocks fetching the oldest. 2 = fetch
    #! group k-2 while k-1, k run. Bounded so device buffers held by
    #! unfetched results stay bounded too.
    dispatch_groups: int = int(os.environ.get(
        "COBS_TPU_DISPATCH_GROUPS", "2"))
    #! threshold-compacted top-k fetch: device top-k programs emit a
    #! packed [B, 8] prefix of the sorted candidate rows alongside the
    #! full [B, k] arrays; when every query's hits >= its score floor
    #! provably fit the prefix (the overwhelmingly common case at the
    #! reference's default -t 0.8), only the 8x-narrower prefix
    #! crosses the device-to-host link (engine.PendingTopK.fetch_topk).
    #! False restores the unconditional full fetch (A/B knob).
    tier_fetch: bool = os.environ.get("COBS_TPU_TIER_FETCH",
                                      "1") not in ("0", "false", "off")


settings = Settings()


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return it: JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself;
    no other path is set), else COMPILE_CACHE_DIR inside the checkout.
    Repeat CLI invocations and new processes then reuse compiled query
    and construction programs."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(COMPILE_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def device_index_budget() -> int:
    """Bytes of device memory an index may take before Search streams
    it from host mmap instead: settings.max_device_index_bytes when set,
    else the first LOCAL device's memory limit (in a multi-process job
    jax.devices()[0] may belong to another process) less
    DEVICE_HEADROOM_BYTES or an eighth of the limit, whichever is
    larger, else DEFAULT_DEVICE_INDEX_BYTES where the backend reports
    no limit."""
    override = settings.max_device_index_bytes
    if override is not None:
        if int(override) < 0:
            raise ValueError("max_device_index_bytes must be >= 0")
        return int(override)
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return DEFAULT_DEVICE_INDEX_BYTES
    return max(0, int(limit) - max(DEVICE_HEADROOM_BYTES, int(limit) // 8))


def disable_cache(disable: bool = True) -> None:
    """Disable reading/writing of document index cache files.

    Mirrors `cobs_index.disable_cache()` (reference: python/module.cpp:389-394).
    """
    settings.disable_cache = disable
