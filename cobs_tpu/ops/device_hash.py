"""Device-side query hashing: window -> canonicalize -> XXH64 -> row id,
entirely on the accelerator.

The serving loop's host->device traffic is otherwise dominated by
precomputed row indices (4 bytes per (term, hash, page) — 4 MB per
1024-query batch on a classic index), and host hashing occupies CPU the
serving loop could use elsewhere. This module moves the whole hash
pipeline into the scoring program: upload the raw query bytes (~1 KB
per query), slide windows, canonicalize, hash, and mod on device.

Parity contracts replicated bit-for-bit (validated against the host
pipeline in tests/test_device_hash.py):

- XXH64 with seed = hash index (reference: cobs/util/misc.hpp:65-72),
  implemented over XLA's uint64 under ``jax.enable_x64()`` (XLA lowers
  it to 32-bit pairs where the device has no 64-bit integer ops), and
  the final
  ``% signature_size`` by a trace-time constant strength-reduces to
  multiply-shift).
- Truncated-half canonicalization, forward wins ties (reference:
  cobs/util/query.cpp:143-199) — same semantics as
  core/canonical.py:canonicalize_batch.
- Invalid-letter and too-short errors stay host-side checks on the raw
  bytes (reference dies per query, classic_search.cpp:93-96), so the
  device program may assume valid input.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _u64(x: int) -> jnp.ndarray:
    return jnp.uint64(x & 0xFFFFFFFFFFFFFFFF)


def _rotl(x, r: int):
    return (x << jnp.uint64(r)) | (x >> jnp.uint64(64 - r))


def _round(acc, lane):
    return _rotl(acc + lane * _u64(_P2), 31) * _u64(_P1)


def _lane64(data, start: int):
    """Little-endian u64 lane from bytes [..., L] at static offset."""
    acc = data[..., start].astype(jnp.uint64)
    for i in range(1, 8):
        acc = acc | (data[..., start + i].astype(jnp.uint64)
                     << jnp.uint64(8 * i))
    return acc


def _lane32(data, start: int):
    acc = data[..., start].astype(jnp.uint64)
    for i in range(1, 4):
        acc = acc | (data[..., start + i].astype(jnp.uint64)
                     << jnp.uint64(8 * i))
    return acc


def xxh64_device(data, length: int, seed: int):
    """XXH64 of uint8 [..., length] under one static seed -> u64 [...].

    Mirrors core/xxh64.py:xxh64 (the spec's single-shot digest) with
    the byte length static, so every chunk loop unrolls at trace time.
    """
    seed64 = _u64(seed)
    pos = 0
    if length >= 32:
        v1 = jnp.broadcast_to(seed64 + _u64(_P1 + _P2), data.shape[:-1])
        v2 = jnp.broadcast_to(seed64 + _u64(_P2), data.shape[:-1])
        v3 = jnp.broadcast_to(seed64, data.shape[:-1])
        v4 = jnp.broadcast_to(seed64 - _u64(_P1), data.shape[:-1])
        for s in range(length // 32):
            v1 = _round(v1, _lane64(data, 32 * s))
            v2 = _round(v2, _lane64(data, 32 * s + 8))
            v3 = _round(v3, _lane64(data, 32 * s + 16))
            v4 = _round(v4, _lane64(data, 32 * s + 24))
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18))
        for v in (v1, v2, v3, v4):
            h = (h ^ _round(jnp.zeros_like(v), v)) * _u64(_P1) \
                + _u64(_P4)
        pos = 32 * (length // 32)
    else:
        h = jnp.broadcast_to(seed64 + _u64(_P5), data.shape[:-1])

    h = h + jnp.uint64(length)

    while length - pos >= 8:
        h = h ^ _round(jnp.zeros_like(h), _lane64(data, pos))
        h = _rotl(h, 27) * _u64(_P1) + _u64(_P4)
        pos += 8
    if length - pos >= 4:
        h = h ^ (_lane32(data, pos) * _u64(_P1))
        h = _rotl(h, 23) * _u64(_P2) + _u64(_P3)
        pos += 4
    while pos < length:
        h = h ^ (data[..., pos].astype(jnp.uint64) * _u64(_P5))
        h = _rotl(h, 11) * _u64(_P1)
        pos += 1

    h = h ^ (h >> jnp.uint64(33))
    h = h * _u64(_P2)
    h = h ^ (h >> jnp.uint64(29))
    h = h * _u64(_P3)
    h = h ^ (h >> jnp.uint64(32))
    return h


def canonicalize_device(windows):
    """Canonicalize uint8 [..., k] windows of VALIDATED ACGT bytes.

    Truncated-half compare, forward wins ties — the same observable
    semantics as core/canonical.py:canonicalize_batch (reference:
    cobs/util/query.cpp:143-199) for valid input. Letters must be
    pre-validated on the host (query mode dies there on non-ACGT), so
    the 256-entry byte maps reduce to arithmetic: the forward map is
    the identity, and the complement is a XOR (A^21=T, T^21=A, C^4=G,
    G^4=C; bit 1 of the ASCII code separates the two pairs) — no
    table gathers, which at [B, T, k] scale dominated the device-hash
    program's cost.
    """
    k = windows.shape[-1]
    pair = jnp.where((windows & jnp.uint8(2)) != 0, jnp.uint8(4),
                     jnp.uint8(21))
    rm = (windows ^ pair)[..., ::-1]                 # reverse complement
    half = k // 2
    if half == 0:
        return windows
    fh = windows[..., :half].astype(jnp.int32)
    rh = rm[..., :half].astype(jnp.int32)
    # first differing position in the compared half decides; all-equal
    # keeps forward (eq_before = exclusive prefix-AND of equality)
    eq = fh == rh
    eq_before = jnp.cumprod(
        jnp.concatenate([jnp.ones_like(eq[..., :1]), eq[..., :-1]],
                        axis=-1), axis=-1).astype(bool)
    use_reverse = (eq_before & ~eq & (fh > rh)).any(axis=-1)
    return jnp.where(use_reverse[..., None], rm, windows)


#: ASCII -> 2-bit code (A=0, C=1, G=2, T=3) for the packed upload path
_ACGT_CODE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ACGT_CODE[_c] = _i


def pack_queries_2bit(qbytes: np.ndarray) -> np.ndarray:
    """Host side: ASCII ACGT [B, L] u8 -> 2-bit packed [B, ceil(L/4)].

    Input must be validated ACGT (+ 'A' padding); 4x less
    host->device traffic than raw bytes — the dominant serving cost on
    slow links once hashing moved on-device."""
    B, L = qbytes.shape
    codes = _ACGT_CODE[qbytes]
    pad = (-L) % 4
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))  # 'A' = code 0
    # all-u8 arithmetic: codes are <= 3, so every shifted lane fits a
    # byte — the u16 widen/narrow round trip doubled memory traffic
    # over these multi-MB arrays for nothing
    c = codes.reshape(B, -1, 4)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6))


def decode_2bit_device(packed, L: int):
    """Device side: 2-bit packed [B, Wp] u8 -> ASCII ACGT [B, L] u8.

    Pure elementwise ops (shifts + a 3-way arithmetic select), no
    table gathers — code 0..3 -> 65/67/71/84."""
    parts = [(packed >> jnp.uint8(2 * j)) & jnp.uint8(3)
             for j in range(4)]
    c = jnp.stack(parts, axis=-1).reshape(packed.shape[0], -1)[:, :L]
    ascii_ = (jnp.uint8(65) + jnp.uint8(2) * c
              + jnp.uint8(2) * (c == 2).astype(jnp.uint8))
    return jnp.where(c == 3, jnp.uint8(84), ascii_)


def rows_from_queries(qdata, qlens, term_size: int, num_hashes: int,
                      canonicalize: int, sig_sizes: tuple,
                      row_offsets: tuple, zero_row: int,
                      packed_len: int = 0):
    """Row-id matrix int32 [B, T, h, P] from raw query bytes on device.

    Args:
      qdata: uint8 [B, L] — queries padded (with any valid letter) to
        the bucketed length L; or, when packed_len = L > 0, the 2-bit
        packed form [B, ceil(L/4)] (pack_queries_2bit).
      qlens: int32 [B] — true byte length of each query.
      sig_sizes / row_offsets: per-page signature sizes and global row
        offsets (trace-time constants, so each ``% sig`` strength-
        reduces); zero_row: global id of the all-zero padding row.

    Terms past a query's true end point at zero_row, exactly like the
    host path's padding (engine._prepare).
    """
    k = term_size
    qbytes = (decode_2bit_device(qdata, packed_len) if packed_len
              else qdata)
    B, L = qbytes.shape
    T = L - k + 1
    # k static slices instead of a [B, T, k] gather (the gather formed
    # 32M scattered byte reads at B=1024 and dominated the program)
    windows = jnp.stack([qbytes[:, i:i + T] for i in range(k)],
                        axis=-1)                     # [B, T, k]
    if canonicalize == 1:
        windows = canonicalize_device(windows)
    hashes = jnp.stack(
        [xxh64_device(windows, k, j) for j in range(num_hashes)],
        axis=-1)                                     # [B, T, h] u64
    pages = []
    for sig, off in zip(sig_sizes, row_offsets):
        pages.append((hashes % jnp.uint64(sig)
                      + jnp.uint64(off)).astype(jnp.int32))
    rows = jnp.stack(pages, axis=-1)                 # [B, T, h, P]
    valid = (jnp.arange(T, dtype=jnp.int32)[None, :]
             < (qlens[:, None] - jnp.int32(k - 1)))  # [B, T]
    return jnp.where(valid[:, :, None, None], rows,
                     jnp.int32(zero_row))


@functools.lru_cache(maxsize=None)
def _valid_dna() -> np.ndarray:
    ok = np.zeros(256, dtype=bool)
    ok[list(b"ACGT")] = True
    return ok


def invalid_query_mask(arr: np.ndarray, canonicalize: int) -> np.ndarray:
    """bool [B]: True where a row holds a non-ACGT byte — the
    vectorized batch analog of validate_queries for uniform-length
    batches (one LUT take + all() for the whole batch instead of
    ~10 us/query of per-query Python)."""
    if canonicalize != 1:
        return np.zeros(arr.shape[0], dtype=bool)
    return ~_valid_dna()[arr].all(axis=1)


def validate_queries(queries: list[bytes], term_size: int,
                     canonicalize: int) -> None:
    """Host-side error parity for the device-hash path: the reference
    dies per query on non-ACGT letters and on too-short queries
    (reference: cobs/query/classic_search.cpp:66-107)."""
    ok = _valid_dna()
    for q in queries:
        if len(q) < term_size:
            raise ValueError(
                f"query too short, needs to be at least {term_size} "
                "characters long")
        if canonicalize == 1 and not ok[
                np.frombuffer(q, dtype=np.uint8)].all():
            raise ValueError("Invalid DNA base pair in query string. "
                             "Only ACGT are allowed.")
