"""Construction parameter objects.

Field-for-field mirrors of the reference parameter structs
(reference: cobs/construction/classic_index.hpp:29-53,
cobs/construction/compact_index.hpp:24-45) so the Python API matches
`cobs_index` (reference: python/module.cpp:192-309).
"""

import dataclasses
import os


def _default_mem_bytes() -> int:
    """80% of system RAM (reference: cobs/util/misc.cpp get_memory_size)."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        return pages * page_size * 80 // 100
    except (ValueError, OSError):
        return 8 << 30


def _default_threads() -> int:
    from cobs_tpu.settings import settings
    return max(1, settings.threads)


@dataclasses.dataclass
class ClassicIndexParameters:
    term_size: int = 31
    canonicalize: int = 1
    num_hashes: int = 1
    false_positive_rate: float = 0.3
    signature_size: int = 0
    mem_bytes: int = dataclasses.field(default_factory=_default_mem_bytes)
    num_threads: int = dataclasses.field(default_factory=_default_threads)
    log_prefix: str = ""
    clobber: bool = False
    continue_: bool = False
    keep_temporary: bool = False
    #: build batch bit matrices on the device (optionally sharded across
    #: a ("batch", "docs") mesh) instead of in native host threads;
    #: output stays byte-identical (an addition, no reference analog)
    device_construct: bool = False


@dataclasses.dataclass
class CompactIndexParameters:
    term_size: int = 31
    canonicalize: int = 1
    num_hashes: int = 1
    false_positive_rate: float = 0.3
    page_size: int = 0
    mem_bytes: int = dataclasses.field(default_factory=_default_mem_bytes)
    num_threads: int = dataclasses.field(default_factory=_default_threads)
    clobber: bool = False
    continue_: bool = False
    keep_temporary: bool = False
    #: see ClassicIndexParameters.device_construct (applies to the
    #: nested per-page classic constructions)
    device_construct: bool = False
