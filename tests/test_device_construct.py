"""Device-side construction produces byte-identical index files.

The sharded device scatter must be wired into the real drivers, not a
demo. These tests construct the same corpus
through the host path and the device path (single device and an
8-virtual-device mesh) and require the output files to be identical
byte for byte (reference pipeline being matched:
cobs/construction/classic_index.cpp:36-189)."""

import numpy as np
import pytest

import cobs_tpu
from cobs_tpu.construct.device import build_batch_matrix_device
from cobs_tpu.construct.bitmatrix import build_batch_matrix
from cobs_tpu.parallel.sharded import make_mesh
from cobs_tpu.settings import settings


@pytest.fixture(autouse=True)
def _no_cache():
    settings.disable_cache = True
    yield
    settings.disable_cache = False
    settings.construct_mesh = None


def _write_corpus(tmp_path, rng, n_docs=20):
    docs = tmp_path / "docs"
    docs.mkdir()
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(n_docs):
        seq = bases[rng.integers(0, 4, size=200 + 37 * i)].tobytes()
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    return docs


@pytest.mark.parametrize("mesh_docs", [0, 8])  # 0 => single device
def test_batch_matrix_device_identical(tmp_path, rng, mesh_docs):
    docs = _write_corpus(tmp_path, rng)
    dl = cobs_tpu.DocumentList(docs)
    entries = dl.list()
    sig, row_size = 4099, -(-len(entries) // 8)
    host = build_batch_matrix(entries, sig, row_size, 31, 2, 1,
                              lambda m: None)
    mesh = make_mesh(1, mesh_docs) if mesh_docs else None
    dev = build_batch_matrix_device(entries, sig, row_size, 31, 2, 1,
                                    lambda m: None, mesh=mesh)
    np.testing.assert_array_equal(dev, host)


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_driver_device_construct_identical_files(tmp_path, rng, kind):
    docs = _write_corpus(tmp_path, rng, n_docs=24)
    dl = cobs_tpu.DocumentList(docs)
    host_idx = tmp_path / f"host.cobs_{kind}"
    dev_idx = tmp_path / f"dev.cobs_{kind}"
    settings.construct_mesh = make_mesh(1, 8)
    if kind == "classic":
        P = cobs_tpu.ClassicIndexParameters
        cobs_tpu.classic_construct(dl, host_idx, index_params=P(
            num_hashes=2, clobber=True))
        cobs_tpu.classic_construct(dl, dev_idx, index_params=P(
            num_hashes=2, clobber=True, device_construct=True))
    else:
        P = cobs_tpu.CompactIndexParameters
        cobs_tpu.compact_construct(dl, host_idx, index_params=P(
            num_hashes=2, page_size=1, clobber=True))
        cobs_tpu.compact_construct(dl, dev_idx, index_params=P(
            num_hashes=2, page_size=1, clobber=True,
            device_construct=True))
    a, b = host_idx.read_bytes(), dev_idx.read_bytes()
    # headers differ only in embedded doc names ordering? they must not:
    # the whole file must match byte for byte
    assert a == b


def test_device_construct_small_batches(tmp_path, rng, monkeypatch):
    """Device batches capped by the HBM budget still combine into the
    same final index (multiple batch files + hierarchical combine)."""
    docs = _write_corpus(tmp_path, rng, n_docs=20)
    dl = cobs_tpu.DocumentList(docs)
    host_idx = tmp_path / "host.cobs_classic"
    dev_idx = tmp_path / "dev.cobs_classic"
    P = cobs_tpu.ClassicIndexParameters
    cobs_tpu.classic_construct(dl, host_idx, index_params=P(clobber=True))
    # budget that forces ~8-doc device batches
    monkeypatch.setattr(settings, "max_device_index_bytes", 1 << 17)
    cobs_tpu.classic_construct(dl, dev_idx, index_params=P(
        clobber=True, device_construct=True))
    assert host_idx.read_bytes() == dev_idx.read_bytes()


def test_cli_device_construct_golden(tmp_path):
    """CLI --device-construct over the parity corpus answers the golden
    query exactly."""
    import shutil
    from cobs_tpu.cli.main import main
    shutil.copytree("tests/data/fasta", tmp_path / "fasta",
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    idx = tmp_path / "x.cobs_classic"
    rc = main(["classic-construct", str(tmp_path / "fasta"), str(idx),
               "--device-construct"])
    assert rc == 0
    s = cobs_tpu.Search(str(idx))
    res = s.search(
        "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT",
        threshold=0.0)
    assert (res[0].doc_name, res[0].score) == ("sample1", 20)
