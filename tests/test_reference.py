"""The NumPy reference scorer (query/reference.py) against Search.

chip_smoke.py holds the device backends to this reference on the card;
here it is held to the golden anchor and to Search on the CPU, on the
parity corpus and on small random indexes (classic, compact, h=3).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

import cobs_tpu
from cobs_tpu.query.reference import ReferenceIndex
from cobs_tpu.query.search import Search
from cobs_tpu.settings import settings

DATA = Path(__file__).parent / "data"
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
GOLDEN_CLASSIC = [("sample1", 20), ("sample7", 3), ("sample2", 1),
                  ("sample4", 1), ("sample6", 1), ("sample3", 0),
                  ("sample5", 0)]


@pytest.fixture(autouse=True)
def _no_cache():
    settings.disable_cache = True
    yield
    settings.disable_cache = False


def _pairs(results):
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


def _build(docs, out, kind, num_hashes=1, page_size=None):
    dl = cobs_tpu.DocumentList(docs)
    if kind == "classic":
        cobs_tpu.classic_construct(
            dl, out, index_params=cobs_tpu.ClassicIndexParameters(
                num_hashes=num_hashes, clobber=True))
    else:
        kw = {} if page_size is None else {"page_size": page_size}
        cobs_tpu.compact_construct(
            dl, out, index_params=cobs_tpu.CompactIndexParameters(
                num_hashes=num_hashes, clobber=True, **kw))
    return out


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_reference_golden(tmp_path, kind):
    docs = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", docs)
    idx = _build(docs, tmp_path / f"g.cobs_{kind}", kind)
    ref = ReferenceIndex(idx)
    assert ref.search(GOLDEN_QUERY, 0.0) == GOLDEN_CLASSIC
    assert ref.search(GOLDEN_QUERY, 0.8) == [("sample1", 20)]
    s = Search(str(idx))
    for t, k in ((0.0, 0), (0.0, 3), (0.8, 0)):
        assert ref.search(GOLDEN_QUERY, t, k) == \
            _pairs([s.search(GOLDEN_QUERY, t, k)])[0]


@pytest.mark.parametrize("kind,num_hashes,page_size",
                         [("classic", 1, None), ("classic", 3, None),
                          ("compact", 2, 1)])
def test_reference_matches_search_random(tmp_path, rng, kind, num_hashes,
                                         page_size):
    docs = tmp_path / "docs"
    docs.mkdir()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    for i in range(30):
        seq = acgt[rng.integers(0, 4, size=120 + 17 * i)].tobytes()
        seqs.append(seq)
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idx = _build(docs, tmp_path / f"r.cobs_{kind}", kind, num_hashes,
                 page_size)
    queries = ([seqs[i][5:95].decode() for i in (0, 7, 29)]
               + [acgt[rng.integers(0, 4, size=n)].tobytes().decode()
                  for n in (31, 64, 300)])
    ref = ReferenceIndex(idx)
    s = Search(str(idx))
    for t, k in ((0.0, 0), (0.3, 5), (0.9, 0)):
        want = [ref.search(q, t, k) for q in queries]
        assert _pairs(s.search_batch(queries, t, k)) == want, (t, k)
    # planted queries rank their own document first with every term
    for i, q in zip((0, 7, 29), queries):
        assert ref.search(q, 0.9, 1) == [(f"d{i:02d}", 90 - 31 + 1)]


def test_reference_rejects_bad_queries(tmp_path):
    docs = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", docs)
    ref = ReferenceIndex(_build(docs, tmp_path / "g.cobs_classic",
                                "classic"))
    with pytest.raises(ValueError, match="too short"):
        ref.search("ACGT")
    with pytest.raises(ValueError, match="Invalid DNA"):
        ref.search("N" * 40)
