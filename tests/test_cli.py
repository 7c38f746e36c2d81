"""CLI subtool coverage (in-process, reference flag semantics)."""

import shutil
from pathlib import Path

import pytest

from cobs_tpu.cli import main as cli
from cobs_tpu.settings import settings

DATA = Path(__file__).parent / "data"
GOLDEN = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"


@pytest.fixture(autouse=True)
def _no_cache():
    settings.disable_cache = True
    yield
    settings.disable_cache = False


@pytest.fixture()
def fasta_dir(tmp_path):
    d = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", d)
    return d


@pytest.fixture()
def classic_index(fasta_dir, tmp_path):
    out = tmp_path / "idx.cobs_classic"
    assert cli.main(["classic-construct", str(fasta_dir), str(out),
                     "--clobber"]) == 0
    return out


def test_query_verbatim(classic_index, capsys):
    assert cli.main(["query", "-i", str(classic_index), "-t", "0",
                     GOLDEN]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "sample1\t20"
    assert len(out) == 7


def test_query_default_threshold(classic_index, capsys):
    assert cli.main(["query", "-i", str(classic_index), GOLDEN]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["sample1\t20"]


def test_query_fasta_file(classic_index, tmp_path, capsys):
    qf = tmp_path / "q.fa"
    qf.write_text(f">one\n{GOLDEN[:40]}\n{GOLDEN[40:]}\n"
                  f">two\n{GOLDEN[:45]}\n")
    assert cli.main(["query", "-i", str(classic_index), "-f", str(qf),
                     "-t", "0.5"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "*one\t1"
    assert out[1] == "sample1\t20"
    assert "*two\t1" in out
    i = out.index("*two\t1")
    assert out[i + 1] == "sample1\t15"


def test_query_multi_index(classic_index, fasta_dir, tmp_path, capsys):
    out2 = tmp_path / "idx2.cobs_compact"
    assert cli.main(["compact-construct", str(fasta_dir), str(out2),
                     "--clobber"]) == 0
    assert cli.main(["query", "-i", str(classic_index),
                     "-i", str(out2), GOLDEN]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    # both indices report sample1 with full score
    assert out.count("sample1\t20") == 2


def test_query_limit(classic_index, capsys):
    assert cli.main(["query", "-i", str(classic_index), "-t", "0",
                     "-l", "3", GOLDEN]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3 and out[0] == "sample1\t20"


def test_unknown_subtool_lists_help(capsys):
    assert cli.main(["no-such-tool"]) != 0


def test_compact_construct_combine(fasta_dir, tmp_path, capsys):
    """classic batches -> compact combine path
    (reference: src/cobs.cpp compact-construct-combine)."""
    import cobs_tpu
    from cobs_tpu.ingest.document_list import DocumentList

    # build per-page classic indices the way compact_construct does,
    # then drive the CLI combiner over the directory
    idx = tmp_path / "c.cobs_compact"
    assert cli.main(["compact-construct", str(fasta_dir),
                     str(tmp_path / "direct.cobs_compact"),
                     "--clobber", "--keep-temporary",
                     "--tmp-path", str(tmp_path / "tmp")]) == 0
    assert (tmp_path / "direct.cobs_compact").is_file()


def test_search_stream_matches_batch(classic_index):
    from cobs_tpu.query.search import Search
    s = Search(str(classic_index))
    queries = [GOLDEN, GOLDEN[:40], GOLDEN[5:]] * 3
    want = s.search_batch(queries, 0.0)
    got = list(s.search_stream(iter(queries), 0.0, batch_size=2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [(r.doc_name, r.score) for r in a] == \
            [(r.doc_name, r.score) for r in b]


def test_search_stream_multipage_compact(tmp_path):
    """Regression: search_stream must apply the per-page word-padding
    strip (PendingScores.fetch) — a multi-page compact index whose
    page_size is not a multiple of 512 shifted every doc past page 0."""
    import numpy as np

    import cobs_tpu
    from cobs_tpu.query.search import Search

    rng = np.random.default_rng(7)
    docs_dir = tmp_path / "docs"
    docs_dir.mkdir()
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    for i in range(24):
        seq = bases[rng.integers(0, 4, size=150 + 31 * i)].tobytes()
        seqs.append(seq)
        (docs_dir / f"doc{i:03d}.fasta").write_bytes(
            b">d\n" + seq + b"\n")
    out = tmp_path / "multi.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(docs_dir), out,
        index_params=cobs_tpu.CompactIndexParameters(
            clobber=True, page_size=1))
    s = Search(str(out), streamed=False)
    assert s.index_files[0].num_pages >= 3
    # queries hitting docs across every page, plus unrelated noise
    queries = [seqs[1][:60].decode(), seqs[10][20:90].decode(),
               seqs[20][:50].decode(), GOLDEN, GOLDEN[5:]]
    want = s.search_batch(queries, 0.0)
    got = list(s.search_stream(iter(queries), 0.0, batch_size=2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert [(r.doc_name, r.score) for r in a] == \
            [(r.doc_name, r.score) for r in b]


def test_topk_path_matches_full_ranking(classic_index):
    from cobs_tpu.query.search import Search
    s = Search(str(classic_index))
    for threshold in (0.0, 0.5, 0.8):
        for k in (1, 3, 7, 50):
            full = s.search_batch([GOLDEN, GOLDEN[2:]], threshold, 0)
            want = [r[:k] for r in full]
            got = s.search_batch([GOLDEN, GOLDEN[2:]], threshold, k)
            for a, b in zip(got, want):
                assert [(r.doc_name, r.score) for r in a] == \
                    [(r.doc_name, r.score) for r in b], (threshold, k)


def test_topk_path_multi_index(classic_index, fasta_dir, tmp_path):
    from cobs_tpu.query.search import Search
    import cobs_tpu
    i2 = tmp_path / "i2.cobs_classic"
    cobs_tpu.classic_construct(
        cobs_tpu.DocumentList(fasta_dir), i2,
        index_params=cobs_tpu.ClassicIndexParameters(clobber=True,
                                                     num_hashes=2))
    s = Search([str(classic_index), str(i2)])
    full = s.search(GOLDEN, 0.0, 0)
    got = s.search(GOLDEN, 0.0, 5)
    assert [(r.doc_name, r.score) for r in got] == \
        [(r.doc_name, r.score) for r in full[:5]]


def test_doctor(capsys):
    """`cobs doctor`: device probe (child process, timeout-guarded),
    native runtime, io_uring, and compile-cache checks all report."""
    assert cli.main(["doctor", "--timeout", "120"]) == 0
    out = capsys.readouterr().out
    assert "DEVICE OK" in out
    assert "NATIVE" in out
    assert "COMPILE CACHE" in out


def test_info(classic_index, fasta_dir, tmp_path, capsys):
    """`cobs info`: header/geometry fields for both formats, --scan
    density statistics within the reference's analytic bound."""
    import re

    assert cli.main(["info", str(classic_index), "--scan"]) == 0
    out = capsys.readouterr().out
    assert "kind            classic" in out
    assert "documents       7" in out
    assert "signature size  8748 bits" in out
    m = re.search(r"max (\d+\.\d+)", out)
    assert m and 0.0 < float(m.group(1)) <= 0.31  # fpr 0.3 bound

    compact = tmp_path / "k.cobs_compact"
    assert cli.main(["compact-construct", str(fasta_dir),
                     str(compact), "--clobber"]) == 0
    capsys.readouterr()
    assert cli.main(["info", str(compact), "--scan"]) == 0
    out = capsys.readouterr().out
    assert "kind            compact" in out
    assert "uniform num_hashes 1" in out
    assert "hint:" in out  # sub-512 B pages get the page-size hint

    assert cli.main(["info", str(tmp_path / "nope.cobs_classic")]) == 1

    # corruption detection: a truncated payload is an ERROR, never
    # silently-wrong statistics
    import shutil as _sh
    trunc = tmp_path / "trunc.cobs_classic"
    _sh.copy(classic_index, trunc)
    with open(trunc, "r+b") as f:
        f.truncate(trunc.stat().st_size - 50)
    capsys.readouterr()
    assert cli.main(["info", str(trunc), "--scan"]) == 1
    assert "corrupt classic index" in capsys.readouterr().err
