"""Property test: every scoring backend returns identical scores.

One random corpus, one batch of random queries; the device-resident
engine, the host-mmap streamed backend, the sharded mesh engine and the
plain NumPy reference scorer must agree bit for bit.
"""


import numpy as np
import pytest

import jax.numpy as jnp

import cobs_tpu
from cobs_tpu.parallel import ShardedIndex, make_mesh
from cobs_tpu.query.reference import ReferenceIndex
from cobs_tpu.query.engine import (
    DeviceIndex,
    StreamedIndex,
    create_hashes,
    score_batch,
)
from cobs_tpu.settings import settings


@pytest.fixture(autouse=True)
def _no_cache():
    settings.disable_cache = True
    yield
    settings.disable_cache = False


@pytest.mark.parametrize("kind,num_hashes", [("classic", 1),
                                             ("classic", 3),
                                             ("compact", 2)])
def test_all_backends_agree(tmp_path, rng, kind, num_hashes):
    docs = tmp_path / "docs"
    docs.mkdir()
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(24):
        seq = bases[rng.integers(0, 4, size=150 + 31 * i)].tobytes()
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idx = tmp_path / f"x.cobs_{kind}"
    dl = cobs_tpu.DocumentList(docs)
    if kind == "classic":
        cobs_tpu.classic_construct(
            dl, idx, index_params=cobs_tpu.ClassicIndexParameters(
                num_hashes=num_hashes, clobber=True))
    else:
        cobs_tpu.compact_construct(
            dl, idx, index_params=cobs_tpu.CompactIndexParameters(
                num_hashes=num_hashes, page_size=1, clobber=True))

    queries = [bases[rng.integers(0, 4, size=n)].tobytes()
               for n in (31, 50, 200, 400)]
    dev = DeviceIndex.from_file(idx)
    hashes = create_hashes(queries, dev.term_size, dev.num_hashes,
                           dev.canonicalize)

    base = score_batch(dev, hashes)

    st = StreamedIndex(idx)
    np.testing.assert_array_equal(st.score_batch(hashes), base,
                                  err_msg="streamed")

    sharded = ShardedIndex(dev, make_mesh(n_batch=2, n_docs=4),
                           word_align=8)
    np.testing.assert_array_equal(sharded.score_batch(hashes), base,
                                  err_msg="sharded")

    ref = ReferenceIndex(idx)
    want = np.stack([ref.scores(q) for q in queries])
    np.testing.assert_array_equal(base[:, :want.shape[1]], want,
                                  err_msg="numpy reference")


def test_chunked_gather_matches_unchunked(rng, monkeypatch):
    """The T-chunked streaming path under a tiny HBM budget must be
    bit-exact vs the single-shot gather (regression: the chunk/pad/
    zero-row logic otherwise only runs on >1 GiB workloads)."""
    import cobs_tpu.query.engine as eng

    sig, W, h = 4099, 8, 2
    matrix = jnp.asarray(np.concatenate([
        rng.integers(0, 1 << 32, size=(sig, W), dtype=np.uint32),
        np.zeros((1, W), np.uint32)], axis=0))
    # T chosen > _CSA_CHUNK so the chunked branch is reachable
    B, T = 3, 517
    rows_idx = rng.integers(0, sig, size=(B, T, h, 1)).astype(np.int32)
    want = np.asarray(eng._gather_and_count(matrix, jnp.asarray(rows_idx), h))

    monkeypatch.setattr(eng, "_GATHER_BYTES_BUDGET", 32 * 1024)
    # re-trace: _gather_and_count branches on the budget at trace time
    chunked = eng._gather_and_count.__wrapped__
    got = np.asarray(chunked(matrix, jnp.asarray(rows_idx), h))
    assert B * T * h * W * 4 > 32 * 1024  # budget actually exceeded
    np.testing.assert_array_equal(got, want)


def test_batch_tiled_gather_matches_untiled(rng, monkeypatch):
    """The batch-tiled wide-row path (lax.map over sub-batches) must be
    bit-exact vs the full-batch path (regression: tiling otherwise only
    triggers on multi-hundred-MB chunks, i.e. wide-corpus shapes)."""
    import cobs_tpu.query.engine as eng

    sig, W, h = 1031, 16, 2
    matrix = jnp.asarray(np.concatenate([
        rng.integers(0, 1 << 32, size=(sig, W), dtype=np.uint32),
        np.zeros((1, W), np.uint32)], axis=0))
    # (6, 517)/(5, 517): chunked plan, Bs=1 under the tiny bound
    # (prime 5 exercises the indivisible case); (4, 120): single-shot
    # plan (T < _CSA_CHUNK) tiled to Bs=2; (1, 300): B=1, untileable
    for B, T in [(6, 517), (5, 517), (4, 120), (1, 300)]:
        rows_idx = rng.integers(
            0, sig, size=(B, T, h, 1)).astype(np.int32)
        want = np.asarray(eng._gather_and_count(
            matrix, jnp.asarray(rows_idx), h))
        monkeypatch.setattr(eng, "_FUSED_CHUNK_BYTES",
                            2 * eng._CSA_CHUNK * h * W * 4)
        tiled = eng._gather_and_count.__wrapped__
        got = np.asarray(tiled(matrix, jnp.asarray(rows_idx), h))
        monkeypatch.undo()
        np.testing.assert_array_equal(got, want, err_msg=f"B={B} T={T}")


def test_plan_batch_tile_invariants():
    from cobs_tpu.query.engine import (_FUSED_CHUNK_BYTES,
                                       _plan_batch_tile)

    for B in [1, 2, 5, 8, 64, 67, 96]:
        for tc, h, P, W in [(128, 1, 1, 384), (256, 3, 1, 6144),
                            (342, 1, 40, 128), (512, 1, 1, 24576)]:
            Bs = _plan_batch_tile(B, tc, h, P, W)
            assert 1 <= Bs <= B and B % Bs == 0
            # under the bound, or indivisible below it
            assert (Bs * tc * h * P * W * 4 <= _FUSED_CHUNK_BYTES
                    or Bs == 1)
    # headline config is untouched (Bs == B)
    assert _plan_batch_tile(64, 342, 1, 1, 384) == 64


def test_bucket_waste_bound():
    """The term-axis bucket ladder caps padding waste at 12.5% —
    zero-row padding gathers cost full HBM time (measured r3), so the
    ladder's waste bound is a throughput contract, not cosmetics."""
    from cobs_tpu.query.engine import _bucket

    prev = 0
    for n in list(range(1, 4097)) + [10_000, 100_000, 1_000_000]:
        b = _bucket(n)
        assert b >= n
        assert b % 16 == 0
        # waste <= one quantum: n/8 once n >= 128, else the 16 floor
        assert b - n < max(16, (n + 1) / 8), (n, b)
        if n >= 128:
            assert b <= n * 1.125, (n, b)
        assert b >= prev  # monotone: longer queries never bucket lower
        prev = b
    assert _bucket(1000) == 1024  # the serving-bucket regression


def test_chunk_for_divides_with_bounded_tail():
    """The adaptive scan chunk never exceeds its target and pads T by
    less than one chunk-count's worth."""
    from cobs_tpu.query.engine import _chunk_for

    for T in list(range(1, 3000)) + [10_000, 106_496]:
        for target in (128, 250, 256, 500):
            tc = _chunk_for(T, target)
            assert 1 <= tc <= target
            n = -(-T // tc)
            assert n * tc - T < n  # tail padding < chunks
            assert n == -(-T // target)  # same dispatch count as fixed


def test_plan_chunks_csa_floor():
    """No planned chunk may fall below the packed-CSA floor (the naive
    expand-sum count is ~15x the VPU work): regression for h>=3
    mid-length buckets like T=192 @ h=3 and T=272 @ h=4."""
    from cobs_tpu.query.engine import _CSA_CHUNK, _plan_chunks

    big = 1 << 30
    for h in (1, 2, 3, 4, 8):
        for T in list(range(1, 2049)) + [4096, 100_000]:
            tc = _plan_chunks(T, h, big)
            if tc is None:
                continue  # single shot
            assert tc >= _CSA_CHUNK or T // 2 < _CSA_CHUNK, (T, h, tc)
            n = -(-T // tc)
            assert n >= 2, (T, h, tc)
            assert n * tc - T < tc  # padding < one chunk


def test_plan_tile_wide_row_regime():
    """Joint (Bs, tc) plan: wide rows fix Bs at the sublane height 8
    and re-pick the term chunk to fill the budget (r4 grid sweep:
    (8, 256) = 128 GB/s vs the tc-first plan's (2, 512) = 52 at 24 KB
    rows); narrow rows keep the full batch and near-500 chunks."""
    from cobs_tpu.query.engine import (
        _CSA_CHUNK,
        _FUSED_CHUNK_BYTES,
        _GATHER_BYTES_BUDGET,
        _plan_chunks,
        _plan_tile,
    )

    def plan(B, T, h, P, W):
        bt = _GATHER_BYTES_BUDGET // max(h * P * W * 4, 1)
        return _plan_tile(B, T, h, P, W, _plan_chunks(T, h, bt))

    # the measured 24 KB-row optimum, exactly
    assert plan(64, 1024, 1, 1, 6144) == (8, 256)
    assert plan(64, 1000, 1, 1, 6144) == (8, 250)
    # headline narrow shape: untouched full batch
    Bs, tc = plan(64, 1024, 1, 1, 384)
    assert Bs == 64 and tc is not None
    # invariants across shapes: Bs divides B, chunk fits the budget,
    # chunks never fall below the packed-CSA floor
    for B in (1, 8, 64, 96):
        for T in (300, 517, 1024, 4096):
            for W in (128, 384, 6144, 24576):
                Bs, tc = plan(B, T, 1, 1, W)
                assert 1 <= Bs <= B and B % Bs == 0
                if tc is not None:
                    assert (Bs * tc * W * 4 <= _FUSED_CHUNK_BYTES
                            or Bs == 1)
                    assert tc >= _CSA_CHUNK or T // 2 < _CSA_CHUNK
