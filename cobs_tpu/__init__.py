"""cobs_tpu: the Compact Bit-Sliced Signature Index on JAX.

A ground-up reimplementation of the capabilities of COBS (Bingmann et al.,
SPIRE 2019) for an accelerator: the bit-sliced signature matrix lives in
device memory as a document-axis-sharded dense array, queries are batched
and executed as fused gather-AND-popcount computations compiled by XLA, and
multi-device scaling uses jax.sharding meshes with XLA collectives.

Public API mirrors the reference `cobs_index` Python module
(reference: python/module.cpp:71-395) so users can switch directly.
"""

from cobs_tpu.settings import configure_compile_cache

configure_compile_cache()

from cobs_tpu.settings import disable_cache, settings
from cobs_tpu.ingest.document_list import (
    DocumentEntry,
    DocumentList,
    FileType,
)
from cobs_tpu.construct.params import (
    ClassicIndexParameters,
    CompactIndexParameters,
)
from cobs_tpu.construct.classic import (
    classic_construct,
    classic_construct_list,
    classic_construct_from_documents,
    classic_combine,
    classic_construct_random,
)
from cobs_tpu.construct.compact import (
    compact_construct,
    compact_construct_list,
    compact_combine_into_compact,
    compact_repack,
)
from cobs_tpu.query.search import QueryError, Search, SearchResult
from cobs_tpu.query.server import QueryServer
from cobs_tpu.query.client import QueryClient

__version__ = "0.1.0"

__all__ = [
    "DocumentEntry",
    "DocumentList",
    "FileType",
    "ClassicIndexParameters",
    "CompactIndexParameters",
    "classic_construct",
    "classic_construct_list",
    "classic_construct_from_documents",
    "classic_combine",
    "classic_construct_random",
    "compact_construct",
    "compact_construct_list",
    "compact_combine_into_compact",
    "compact_repack",
    "QueryClient",
    "QueryError",
    "QueryServer",
    "Search",
    "SearchResult",
    "disable_cache",
    "settings",
]
