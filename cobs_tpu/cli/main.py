"""`cobs` command-line interface.

The same 11 subtools as the reference CLI with the same flag names and
defaults (reference: src/cobs.cpp:970-1016): doc-list, doc-dump,
classic-construct, classic-construct-random, compact-construct,
compact-construct-combine, query, print-parameters, print-kmers,
benchmark-fpr, generate-queries.
"""

import argparse
import sys
import time

import numpy as np

FILE_TYPE_HELP = (
    'filter documents by file type (any, text, cortex, cobs, fasta, '
    'fastq, fasta_multi, fastq_multi, list)')


def _add_threads_flag(p):
    p.add_argument("-T", "--threads", type=int, default=None,
                   help="number of threads to use, default: max cores")


def _parser_with_num_hashes(prog) -> argparse.ArgumentParser:
    """Parser whose `-h` means --num-hashes, matching the reference CLI
    (reference: src/cobs.cpp:186); help stays available as --help."""
    p = argparse.ArgumentParser(prog=prog, add_help=False)
    p.add_argument("--help", action="help",
                   help="show this help message and exit")
    return p


def _add_num_hashes_flag(p, default=1):
    p.add_argument("-h", "-h2", "--num-hashes", type=int, default=default,
                   dest="num_hashes",
                   help=f"number of hash functions, default: {default}")


def _apply_threads(args):
    if getattr(args, "threads", None):
        from cobs_tpu.settings import settings
        settings.threads = args.threads


def _parse_bytes(s: str) -> int:
    """Parse '4G', '512M', '80%' style byte sizes."""
    s = s.strip()
    mult = 1
    suffixes = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
    low = s.lower()
    for suf, m in suffixes.items():
        if low.endswith(suf + "i") or low.endswith(suf + "ib") or \
                low.endswith(suf + "b") or low.endswith(suf):
            mult = m
            s = s[:s.lower().find(suf)]
            break
    return int(float(s) * mult)


# ---------------------------------------------------------------- doc tools

def _print_document_list(filelist, term_size, os_=None):
    os_ = os_ or sys.stdout
    print("--- document list (" + str(filelist.size()) + " entries) ---",
          file=os_)
    total, min_t, max_t = 0, None, 0
    for i, e in enumerate(filelist.list()):
        t = e.num_terms(term_size)
        total += t
        min_t = t if min_t is None else min(min_t, t)
        max_t = max(max_t, t)
        print(f"document[{i}] size {e.size} {e.type.name} "
              f"terms {t} : {e.path} : {e.name}", file=os_)
    print(f"--- end of document list ({filelist.size()} entries) ---",
          file=os_)
    print(f"documents: {filelist.size()}", file=os_)
    if filelist.size():
        print(f"minimum {term_size}-mers: {min_t}", file=os_)
        print(f"maximum {term_size}-mers: {max_t}", file=os_)
        print(f"average {term_size}-mers: "
              f"{int(total / filelist.size())}", file=os_)
        print(f"total {term_size}-mers: {total}", file=os_)


def cmd_doc_list(argv):
    p = argparse.ArgumentParser(prog="cobs doc-list")
    p.add_argument("path")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    p.add_argument("-k", "--term-size", type=int, default=31)
    args = p.parse_args(argv)

    from cobs_tpu.ingest.document_list import DocumentList, \
        string_to_file_type
    filelist = DocumentList(args.path, string_to_file_type(args.file_type))
    _print_document_list(filelist, args.term_size)
    return 0


def cmd_doc_dump(argv):
    p = argparse.ArgumentParser(prog="cobs doc-dump")
    p.add_argument("path")
    p.add_argument("-k", "--term-size", type=int, default=31)
    p.add_argument("--no-canonicalize", action="store_true")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    args = p.parse_args(argv)

    from cobs_tpu.core.canonical import canonicalize_batch
    from cobs_tpu.ingest.document_list import DocumentList, \
        string_to_file_type
    filelist = DocumentList(args.path, string_to_file_type(args.file_type))
    print(f"Found {filelist.size()} documents.", file=sys.stderr)
    for i, e in enumerate(filelist.list()):
        print(f"document[{i}] : {e.path} : {e.name}", file=sys.stderr)
        count = 0
        for w in e.term_windows(args.term_size):
            count += w.shape[0]
            if args.no_canonicalize:
                for row in w:
                    sys.stdout.write(row.tobytes().decode() + "\n")
            else:
                canon, good = canonicalize_batch(w)
                for row, g, raw in zip(canon, good, w):
                    if not g:
                        sys.stdout.write("Invalid DNA base pair: "
                                         + raw.tobytes().decode() + "\n")
                    else:
                        sys.stdout.write(row.tobytes().decode() + "\n")
        sys.stdout.flush()
        print(f"document[{i}] : {count} terms.", file=sys.stderr)
    return 0


# ------------------------------------------------------------- construction

def _construct_common_flags(p, compact=False):
    p.add_argument("input", help="path to the input directory or file")
    p.add_argument("out_file", help="path to the output index file")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    p.add_argument("-m", "--memory", default=None,
                   help="memory in bytes to use")
    _add_num_hashes_flag(p)
    p.add_argument("-f", "--false-positive-rate", type=float, default=0.3)
    p.add_argument("-k", "--term-size", type=int, default=31)
    p.add_argument("--no-canonicalize", action="store_true")
    p.add_argument("-C", "--clobber", action="store_true",
                   help="erase output directory if it exists")
    p.add_argument("--continue", dest="continue_", action="store_true",
                   help="continue in existing output directory")
    _add_threads_flag(p)
    p.add_argument("--keep-temporary", action="store_true")
    p.add_argument("--tmp-path", default=None)
    p.add_argument("--device-construct", action="store_true",
                   help="build batch bit matrices on the device "
                        "(sharded across all devices); output is "
                        "byte-identical to the host path")
    if compact:
        p.add_argument("-p", "--page-size", type=int, default=0,
                       help="page size of the compact index, "
                            "default: sqrt(#documents)")


def cmd_classic_construct(argv):
    p = _parser_with_num_hashes("cobs classic-construct")
    _construct_common_flags(p)
    args = p.parse_args(argv)
    _apply_threads(args)

    import cobs_tpu
    params = cobs_tpu.ClassicIndexParameters(
        term_size=args.term_size,
        canonicalize=0 if args.no_canonicalize else 1,
        num_hashes=args.num_hashes,
        false_positive_rate=args.false_positive_rate,
        clobber=args.clobber, continue_=args.continue_,
        keep_temporary=args.keep_temporary,
        device_construct=args.device_construct)
    if args.memory:
        params.mem_bytes = _parse_bytes(args.memory)
    if args.threads:
        params.num_threads = args.threads

    from cobs_tpu.ingest.document_list import DocumentList, \
        string_to_file_type
    filelist = DocumentList(args.input, string_to_file_type(args.file_type))
    _print_document_list(filelist, params.term_size, sys.stderr)
    cobs_tpu.classic_construct(filelist, args.out_file, args.tmp_path,
                               params)
    return 0


def cmd_classic_construct_random(argv):
    p = _parser_with_num_hashes("cobs classic-construct-random")
    p.add_argument("out_file")
    p.add_argument("-s", "--signature-size", default=str(2 * 1024 * 1024),
                   help="number of bits of the signatures, default: 2 Mi")
    p.add_argument("-n", "--num-documents", type=int, default=10000)
    p.add_argument("-m", "--document-size", type=int, default=1000000)
    _add_num_hashes_flag(p)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    import cobs_tpu
    seed = args.seed if args.seed is not None else \
        int.from_bytes(np.random.bytes(4), "little")
    cobs_tpu.classic_construct_random(
        args.out_file, _parse_bytes(args.signature_size),
        args.num_documents, args.document_size, args.num_hashes, seed)
    return 0


def cmd_compact_construct(argv):
    p = _parser_with_num_hashes("cobs compact-construct")
    _construct_common_flags(p, compact=True)
    args = p.parse_args(argv)
    _apply_threads(args)

    import cobs_tpu
    params = cobs_tpu.CompactIndexParameters(
        term_size=args.term_size,
        canonicalize=0 if args.no_canonicalize else 1,
        num_hashes=args.num_hashes,
        false_positive_rate=args.false_positive_rate,
        page_size=args.page_size,
        clobber=args.clobber, continue_=args.continue_,
        keep_temporary=args.keep_temporary,
        device_construct=args.device_construct)
    if args.memory:
        params.mem_bytes = _parse_bytes(args.memory)
    if args.threads:
        params.num_threads = args.threads

    from cobs_tpu.ingest.document_list import DocumentList, \
        string_to_file_type
    filelist = DocumentList(args.input, string_to_file_type(args.file_type))
    _print_document_list(filelist, params.term_size, sys.stderr)
    cobs_tpu.compact_construct(filelist, args.out_file, args.tmp_path,
                               params)
    return 0


def cmd_repack(argv):
    p = argparse.ArgumentParser(prog="cobs repack")
    p.add_argument("in_file", help="compact index to repack")
    p.add_argument("out_file", help="output compact index")
    p.add_argument("-p", "--page-size", type=int, default=0,
                   help="target page size in bytes (achievable sizes "
                        "are multiples of the input's; default: merge "
                        "maximally)")
    p.add_argument("--clobber", action="store_true",
                   help="overwrite output file if it exists")
    args = p.parse_args(argv)

    from cobs_tpu.construct.compact import compact_repack
    from cobs_tpu.fmt import compact as fmt_compact
    h, _ = fmt_compact.read_compact_header(args.in_file)
    new_page = compact_repack(args.in_file, args.out_file,
                              page_size=args.page_size,
                              clobber=args.clobber)
    print(f"repacked {len(h.parameters)} pages of {h.page_size} B into "
          f"{len(h.parameters) * h.page_size // new_page} pages of "
          f"{new_page} B (bit-preserving per document)")
    return 0


def cmd_compact_construct_combine(argv):
    p = argparse.ArgumentParser(prog="cobs compact-construct-combine")
    p.add_argument("in_dir")
    p.add_argument("out_file")
    p.add_argument("-p", "--page-size", type=int, default=8192,
                   help="page size of the compact index, default: 8192")
    args = p.parse_args(argv)

    import cobs_tpu
    cobs_tpu.compact_combine_into_compact(args.in_dir, args.out_file,
                                          args.page_size)
    return 0


# ------------------------------------------------------------------- query

def cmd_query(argv):
    p = argparse.ArgumentParser(prog="cobs query")
    p.add_argument("-i", "--index", action="append", default=[],
                   help="path to index file(s)")
    p.add_argument("query", nargs="?", default="",
                   help="the text sequence to search for")
    p.add_argument("-f", "--file", default="",
                   help="query (fasta) file to process")
    p.add_argument("-t", "--threshold", type=float, default=0.8,
                   help="threshold in percentage of terms in query "
                        "matching, default: 0.8")
    p.add_argument("-l", "--limit", type=int, default=0,
                   help="number of results to return, default: all")
    p.add_argument("--load-complete", action="store_true",
                   help="force the whole index into device HBM")
    p.add_argument("--streamed", action="store_true",
                   help="force the host-mmap backend (index larger "
                        "than device HBM)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the index over the first N devices "
                        "(document-axis tensor parallelism)")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="capture a jax.profiler device trace into DIR")
    _add_threads_flag(p)
    args = p.parse_args(argv)
    _apply_threads(args)
    if args.load_complete:
        from cobs_tpu.settings import settings
        settings.load_complete_index = True

    import cobs_tpu
    mesh = None
    if args.mesh:
        from cobs_tpu.parallel.sharded import make_mesh
        import jax
        mesh = make_mesh(n_batch=1, n_docs=args.mesh,
                         devices=jax.devices()[:args.mesh])
    s = cobs_tpu.Search(args.index, mesh=mesh,
                        streamed=True if args.streamed else None)

    import contextlib
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        import jax
        profile_ctx = jax.profiler.trace(args.profile)

    if args.query:
        with profile_ctx:
            for res in s.search(args.query, args.threshold, args.limit):
                print(f"{res.doc_name}\t{res.score}")
    elif args.file:
        # FASTA query file: batch all sequences into one device launch
        comments, queries = [], []
        comment, parts = "", []
        with open(args.file) as qf:
            for line in qf:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line[0] in ">;":
                    if parts:
                        comments.append(comment)
                        queries.append("".join(parts))
                    comment, parts = "*" + line[1:], []
                else:
                    parts.append(line)
        if parts:
            comments.append(comment)
            queries.append("".join(parts))
        with profile_ctx:
            results = s.search_batch(queries, args.threshold, args.limit)
        for comment, result in zip(comments, results):
            print(f"{comment}\t{len(result)}")
            for res in result:
                print(f"{res.doc_name}\t{res.score}")
    else:
        print("Pass a verbatim query or a query file.", file=sys.stderr)
        return -1
    s.timer().print("search")
    return 0


def cmd_serve(argv):
    """Resident batching query server (an addition: the reference's
    query loop is one-shot per process, src/cobs.cpp:471-527; a serving
    deployment keeps the index in HBM and coalesces client queries into
    device batches — see cobs_tpu/query/server.py)."""
    p = argparse.ArgumentParser(prog="cobs serve")
    p.add_argument("-i", "--index", action="append", default=[],
                   help="path to index file(s)")
    p.add_argument("--socket", default="", metavar="PATH",
                   help="serve on a Unix domain socket at PATH")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7687,
                   help="TCP port (used when --socket is not given), "
                        "default: 7687")
    p.add_argument("-t", "--threshold", type=float, default=0.8,
                   help="server score floor, default: 0.8 (requests "
                        "above it are fast prefix cuts; below it, the "
                        "batch re-ranks at the lower threshold)")
    p.add_argument("-l", "--limit", type=int, default=0,
                   help="top-k serving mode: cap results per query "
                        "on device, default: 0 = full ranking")
    p.add_argument("-b", "--batch", type=int, default=64,
                   help="max queries coalesced per device batch")
    p.add_argument("--linger-ms", type=float, default=2.0,
                   help="batching window after the first query of a "
                        "batch arrives, default: 2 ms")
    p.add_argument("--warmup", type=int, default=0, metavar="LEN",
                   help="pre-compile the scoring program for LEN-"
                        "character queries before accepting clients "
                        "(a cold compile takes seconds)")
    p.add_argument("--log-interval", type=float, default=0.0,
                   metavar="SECS",
                   help="print a RESULT throughput/counter line every "
                        "SECS seconds (0 = off)")
    p.add_argument("--stall-timeout", type=float, default=300.0,
                   metavar="SECS",
                   help="liveness breaker: when the scoring pipeline "
                        "makes no progress for SECS (stuck device / "
                        "long reload), answer NEW queries with an "
                        "error instead of queueing them forever; "
                        "default: 300, 0 disables")
    p.add_argument("--slo-ms", type=float, default=0.0, metavar="MS",
                   help="p99 latency target: adaptively cap the deep-"
                        "queue mega-dispatch group size (and the "
                        "linger) so tail latency stays under MS "
                        "instead of growing with throughput; "
                        "default: 0 = pure-throughput mode")
    p.add_argument("--load-complete", action="store_true",
                   help="force the whole index into device HBM")
    p.add_argument("--streamed", action="store_true",
                   help="force the host-mmap backend")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the index over the first N devices")
    _add_threads_flag(p)
    args = p.parse_args(argv)
    _apply_threads(args)
    if not args.index:
        print("Pass at least one -i index.", file=sys.stderr)
        return -1
    if args.load_complete:
        from cobs_tpu.settings import settings
        settings.load_complete_index = True

    import cobs_tpu
    from cobs_tpu.query.server import QueryServer
    mesh = None
    if args.mesh:
        import jax

        from cobs_tpu.parallel.sharded import make_mesh
        mesh = make_mesh(n_batch=1, n_docs=args.mesh,
                         devices=jax.devices()[:args.mesh])
    def factory(paths=None):
        return cobs_tpu.Search(
            list(paths) if paths else args.index, mesh=mesh,
            streamed=True if args.streamed else None)

    server = QueryServer(
        factory(), unix_path=args.socket or None, host=args.host,
        port=args.port, batch_size=args.batch,
        linger_ms=args.linger_ms, threshold=args.threshold,
        num_results=args.limit, search_factory=factory,
        stall_timeout=args.stall_timeout, slo_ms=args.slo_ms)
    if args.warmup:
        server.warmup(args.warmup)
        print(f"WARM query_len={args.warmup}", flush=True)
    addr = server.address
    addr = addr if isinstance(addr, str) else f"{addr[0]}:{addr[1]}"
    print(f"SERVING {addr} floor_t={args.threshold} "
          f"limit={args.limit} batch={args.batch} "
          f"linger_ms={args.linger_ms}", flush=True)

    import signal

    def _graceful(signum, frame):
        # drain queued requests and in-flight batches, then exit 0
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    try:
        server.serve_forever(log_interval=args.log_interval)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def _scan_ones(path, offset: int, num_rows: int, row_bytes: int):
    """Per-doc-slot set-bit counts over a row-major bitmap, streamed
    in ~32 MB chunks (constant memory; unpacking a multi-GB payload
    whole would cost 8x the file size in RAM)."""
    import numpy as np

    from cobs_tpu.fmt.magic import FileIOError

    ones = np.zeros(8 * row_bytes, dtype=np.int64)
    rows_per_chunk = max(1, (32 << 20) // max(1, row_bytes))
    with open(path, "rb") as f:
        f.seek(offset)
        remaining = num_rows
        while remaining:
            n = min(rows_per_chunk, remaining)
            chunk = np.fromfile(f, dtype=np.uint8,
                                count=n * row_bytes)
            if chunk.size != n * row_bytes:
                raise FileIOError(
                    f'truncated index payload in "{path}"')
            ones += np.unpackbits(
                chunk.reshape(n, row_bytes), axis=1,
                bitorder="little").sum(axis=0, dtype=np.int64)
            remaining -= n
    return ones


def cmd_info(argv):
    """Inspect an index file: header fields, geometry, sizes; --scan
    adds payload statistics (per-document set-bit ratio vs the
    analytic expectation — the density oracle the reference's tests
    assert, reference: tests/classic_index_construction.cpp:87-92)."""
    p = argparse.ArgumentParser(prog="cobs info")
    p.add_argument("index", help="index file (classic or compact)")
    p.add_argument("--scan", action="store_true",
                   help="scan the payload: ones ratio + corruption "
                        "check (reads the whole file)")
    args = p.parse_args(argv)

    import os

    import numpy as np

    from cobs_tpu.fmt import classic as fc
    from cobs_tpu.fmt import compact as fco
    from cobs_tpu.fmt.magic import FileIOError
    from cobs_tpu.utils.misc import format_iec

    path = args.index
    size = os.path.getsize(path)
    if fc.is_classic_file(path):
        h = fc.read_classic_header(path)
        print(f"kind            classic ({fc.FILE_EXTENSION})")
        print(f"file size       {format_iec(size)}")
        print(f"term size       {h.term_size}")
        print(f"canonicalize    {h.canonicalize}")
        print(f"num hashes      {h.num_hashes}")
        print(f"signature size  {h.signature_size} bits")
        print(f"documents       {len(h.file_names)}")
        print(f"row size        {h.row_size} B "
              f"(8-aligned doc slots: {8 * h.row_size})")
        print(f"payload         "
              f"{format_iec(h.signature_size * h.row_size)}")
        if args.scan:
            import io

            buf = io.BytesIO()
            h.serialize(buf)
            hdr_len = buf.tell()
            payload = h.signature_size * h.row_size
            if hdr_len + payload != size:
                raise FileIOError(
                    f'corrupt classic index "{path}": header '
                    f"{hdr_len} B + payload {payload} B != file "
                    f"size {size} B")
            # constant-memory scan: multi-GB payloads must not
            # materialize an 8x unpacked copy
            ones = _scan_ones(path, hdr_len, h.signature_size,
                              h.row_size)
            ratio = ones / float(h.signature_size)
            n = len(h.file_names)
            print(f"ones ratio      min {ratio[:n].min():.6f} "
                  f"mean {ratio[:n].mean():.6f} "
                  f"max {ratio[:n].max():.6f}")
            pad = ratio[n:]
            if pad.size and pad.max() > 0:
                print("WARNING: padding doc slots contain set bits")
    elif fco.is_compact_file(path):
        h, payload_off = fco.read_compact_header(path)
        print(f"kind            compact ({fco.FILE_EXTENSION})")
        print(f"file size       {format_iec(size)}")
        print(f"term size       {h.term_size}")
        print(f"canonicalize    {h.canonicalize}")
        print(f"page size       {h.page_size} B "
              f"({8 * h.page_size} docs/page)")
        print(f"pages           {len(h.parameters)}")
        print(f"documents       {len(h.file_names)}")
        sigs = [p_.signature_size for p_ in h.parameters]
        nhs = sorted({p_.num_hashes for p_ in h.parameters})
        nh_txt = (f"uniform num_hashes {nhs[0]}" if len(nhs) == 1
                  else f"num_hashes {nhs[0]}..{nhs[-1]} "
                       "(NON-UNIFORM: unqueryable)")
        print(f"signature sizes {min(sigs)}..{max(sigs)} bits "
              f"({nh_txt})")
        payload = sum(s * h.page_size for s in sigs)
        print(f"payload         {format_iec(payload)} "
              f"(starts page-aligned at {payload_off})")
        m = fco.coalesce_factor(
            [(p_.signature_size, p_.num_hashes)
             for p_ in h.parameters])
        if m > 1:
            print(f"mergeable       groups of {m} equal-size pages -> "
                  f"{m * h.page_size} B pages, bit-preserving "
                  f"(`cobs repack`; the query engine merges in HBM "
                  "automatically)")
        else:
            runs = fco.coalesce_runs(
                [(p_.signature_size, p_.num_hashes)
                 for p_ in h.parameters])
            if any(n > 1 for _, n in runs):
                print(f"mergeable       {len(runs)} equal-size RUNS "
                      f"(longest {max(n for _, n in runs)} pages); no "
                      "uniform factor, so `cobs repack` cannot "
                      "materialize it — the query engine merges the "
                      "runs in HBM automatically")
        if h.page_size < 512:
            extra = ("" if m * h.page_size >= 512
                     else "; rebuild with --page-size >= 512 for "
                          "query-heavy workloads")
            print(f"hint: {h.page_size} B pages pad to the engine's "
                  "128-word row alignment at query time, so most "
                  "gathered bytes are padding; page_size >= 512 avoids "
                  f"it (docs/tutorial.md){extra}")
        if args.scan:
            if payload_off + payload != size:
                raise FileIOError(
                    f'corrupt compact index "{path}": header+padding '
                    f"{payload_off} B + payload {payload} B != file "
                    f"size {size} B")
            doc, pos, worst = 0, payload_off, 0.0
            for prm in h.parameters:
                ones = _scan_ones(path, pos, prm.signature_size,
                                  h.page_size)
                pos += prm.signature_size * h.page_size
                n_here = min(len(h.file_names) - doc, 8 * h.page_size)
                if n_here > 0:
                    worst = max(worst, float(
                        (ones[:n_here] / prm.signature_size).max()))
                doc += n_here
            print(f"ones ratio      max over pages {worst:.6f}")
    else:
        raise FileIOError(
            f'Could not open index path "{path}" (unknown format)')
    return 0


def cmd_doctor(argv):
    """Deployment self-check (an addition; the reference has none).
    The device probe runs in a CHILD process under a timeout, so the
    parent never initialises a backend: a device that does not answer
    is reported, not waited on."""
    p = argparse.ArgumentParser(prog="cobs doctor")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="seconds to wait for the device probe "
                        "(default 60)")
    args = p.parse_args(argv)

    import json
    import os
    import platform
    import subprocess
    import tempfile

    import numpy as np

    failures = 0
    print(f"python {sys.version.split()[0]} on {platform.platform()}")
    import jax
    print(f"jax {jax.__version__}  "
          f"JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS', '(unset)')}")

    # --- device: child process so an unresponsive backend cannot hang us
    probe = (
        "import json, time\n"
        "import jax\n"
        "t0 = time.time()\n"
        "ds = jax.devices()\n"
        "import numpy as np, jax.numpy as jnp\n"
        "y = np.asarray(jnp.arange(8.0) * 2)\n"
        "assert y[3] == 6.0\n"
        "print(json.dumps({'n': len(ds),"
        " 'platform': ds[0].platform,"
        " 'kind': ds[0].device_kind,"
        " 'roundtrip_s': round(time.time() - t0, 2)}))\n")
    try:
        r = subprocess.run([sys.executable, "-c", probe],
                           capture_output=True, text=True,
                           timeout=args.timeout)
        info = None
        for line in (r.stdout or "").splitlines():
            if line.startswith("{"):
                try:
                    info = json.loads(line)
                except ValueError:
                    pass  # stray brace-prefixed log line, not ours
        if r.returncode == 0 and info:
            print(f"DEVICE OK: {info['n']}x {info['kind']} "
                  f"({info['platform']}), first op round-trip "
                  f"{info['roundtrip_s']}s")
        else:
            failures += 1
            tail = (r.stderr or "").strip().splitlines()[-1:]
            print(f"DEVICE FAILED: probe exited {r.returncode}"
                  + (f" ({tail[0]})" if tail else ""))
    except subprocess.TimeoutExpired:
        failures += 1
        print(f"DEVICE UNREACHABLE: backend init/round-trip did not "
              f"return within {args.timeout:.0f}s - the device may be "
              "held by another process (a JAX process reserves most of "
              "a GPU's memory) or busy with a backlog of work. "
              "Recovery: stop other processes on the device, retry "
              "with a longer --timeout.")

    # --- native host runtime + io_uring
    from cobs_tpu import native
    if native.lib() is not None:
        print("NATIVE OK: C++ host kernels loaded "
              "(hashing, scatter, row gather, scoring)")
        with tempfile.NamedTemporaryFile() as f:
            f.write(b"x" * 4096)
            f.flush()
            out = np.empty((2, 16), dtype=np.uint8)
            if native.gather_rows_file(f.name, 0, 16,
                                       np.array([0, 4], np.int64),
                                       out, dontcache=True):
                dc = ("cache-bypass (RWF_DONTCACHE) reads available"
                      if native.dontcache_supported()
                      else "RWF_DONTCACHE unsupported here - cold "
                           "benchmarks use per-batch eviction")
                print(f"IO_URING OK: batched async row reads; {dc}")
            else:
                print("IO_URING UNAVAILABLE: cold-cache streamed "
                      "queries fall back to threaded mmap (seccomp "
                      "or pre-5.1 kernel?)")
    else:
        print("NATIVE UNAVAILABLE: NumPy fallbacks in use "
              "(set COBS_TPU_NO_NATIVE=0 and check g++)"
              if os.environ.get("COBS_TPU_NO_NATIVE")
              else "NATIVE UNAVAILABLE: build failed - check g++; "
                   "NumPy fallbacks in use")

    # --- persistent compile cache
    cache = jax.config.jax_compilation_cache_dir
    if cache and os.path.isdir(cache):
        n = sum(1 for _ in os.scandir(cache))
        print(f"COMPILE CACHE OK: {cache} ({n} entries)")
    elif cache:
        print(f"COMPILE CACHE EMPTY: {cache} (created on first use)")
    else:
        print("COMPILE CACHE DISABLED")

    from cobs_tpu.settings import settings
    print(f"settings: threads={settings.threads} "
          f"device_hash={settings.device_hash} "
          f"streamed_score={settings.streamed_host_score}")
    return 1 if failures else 0


# ------------------------------------------------------------------- misc

def cmd_print_parameters(argv):
    p = _parser_with_num_hashes("cobs print-parameters")
    _add_num_hashes_flag(p)
    p.add_argument("-f", "--false-positive-rate", type=float, default=0.3)
    p.add_argument("-n", "--num-elements", default="0")
    args = p.parse_args(argv)

    from cobs_tpu.core.params import (calc_signature_size,
                                      calc_signature_size_ratio)
    from cobs_tpu.utils.misc import format_iec
    num_elements = _parse_bytes(args.num_elements)
    if num_elements == 0:
        print(calc_signature_size_ratio(args.num_hashes,
                                        args.false_positive_rate))
    else:
        sig = calc_signature_size(num_elements, args.num_hashes,
                                  args.false_positive_rate)
        print(f"signature_size = {sig}")
        print(f"signature_bytes = {sig // 8} = {format_iec(sig // 8)}")
    return 0


def cmd_print_kmers(argv):
    p = argparse.ArgumentParser(prog="cobs print-kmers")
    p.add_argument("query")
    p.add_argument("-k", "--kmer-size", type=int, default=31)
    args = p.parse_args(argv)

    from cobs_tpu.core.canonical import canonicalize_batch
    from cobs_tpu.ingest.util import sliding_windows
    q = np.frombuffer(args.query.encode(), dtype=np.uint8)
    windows = sliding_windows(q, args.kmer_size)
    # the reference emits size-k windows for i in [0, |q|-k), one fewer
    # than the total window count (reference: src/cobs.cpp:584-597)
    windows = windows[:max(0, len(args.query) - args.kmer_size)]
    if windows.shape[0]:
        canon, good = canonicalize_batch(windows)
        for row, g, raw in zip(canon, good, windows):
            if not g:
                print("Invalid DNA base pair: " + raw.tobytes().decode())
            else:
                print(row.tobytes().decode())
    return 0


def cmd_benchmark_fpr(argv):
    p = argparse.ArgumentParser(prog="cobs benchmark-fpr")
    p.add_argument("in_file")
    p.add_argument("-k", "--num-kmers", type=int, default=1000)
    p.add_argument("-q", "--queries", type=int, default=10000)
    p.add_argument("-w", "--warmup", type=int, default=100)
    p.add_argument("-d", "--dist", action="store_true",
                   help="calculate false positive distribution")
    p.add_argument("-b", "--batch", type=int, default=64,
                   help="queries per device batch (an addition; the "
                        "reference scores one query at a time)")
    p.add_argument("-t", "--threshold", type=float, default=0.0,
                   help="score threshold fraction (reference query "
                        "default is 0.8)")
    p.add_argument("-l", "--limit", type=int, default=0,
                   help="top-k results per query (0 = full ranking); "
                        "exercises the sparse top-k serving path")
    p.add_argument("--streamed", action="store_true",
                   help="benchmark the host-mmap streamed backend")
    p.add_argument("--cold", action="store_true",
                   help="evict the index from the OS page cache after "
                        "every batch (posix_fadvise DONTNEED; implies "
                        "--streamed) so numbers reflect disk, not cache")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from cobs_tpu.query.engine import StreamedIndex
    from cobs_tpu.query.search import Search
    from cobs_tpu.utils.misc import random_sequence_rng
    rng = np.random.default_rng(args.seed)

    if args.cold or args.streamed:
        backend = StreamedIndex(args.in_file, drop_cache=args.cold)
        s = Search(backend)
        n_warm = args.warmup
    else:
        backend = None
        s = Search(args.in_file)
        # a device backend's measured loop packs up to mega_batches
        # batches per program (powers of two): the warmup must run
        # enough queries THROUGH THE STREAM to compile every ladder
        # variant, or those compiles land inside measured t_io
        from cobs_tpu.settings import settings as _st
        n_warm = max(args.warmup,
                     args.batch * 2 * max(1, _st.mega_batches))
    warmup = [random_sequence_rng(args.num_kmers + 30, rng)
              for _ in range(n_warm)]
    queries = [random_sequence_rng(args.num_kmers + 30, rng)
               for _ in range(args.queries)]
    # warm through the SAME streaming path as the measured loop (the
    # sync search_batch compiles a different, single-batch program)
    for _ in s.search_stream(warmup, threshold=args.threshold,
                             num_results=args.limit,
                             batch_size=args.batch):
        pass
    s.timer().reset()
    if args.cold:
        backend.drop_cache()  # the measured loop starts cold too

    counts: dict[int, int] = {}
    t0 = time.perf_counter()
    last_result = []
    # the serving loop: overlapped hashing + a bounded in-flight device
    # window (Search.search_stream)
    for res_list in s.search_stream(queries, threshold=args.threshold,
                                    num_results=args.limit,
                                    batch_size=args.batch):
        # reference parity: results= is the LAST query's hit count
        # (reference: src/cobs.cpp:655)
        last_result = res_list
        if args.dist:
            for r in res_list:
                counts[r.score] = counts.get(r.score, 0) + 1
    elapsed = time.perf_counter() - t0

    t = s.timer()
    print("RESULT"
          " name=benchmark "
          f" index={args.in_file}"
          f" kmer_queries={len(queries[0]) - 30}"
          f" queries={len(queries)}"
          f" warmup={len(warmup)}"
          f" results={len(last_result)}"
          f" batch={args.batch}"
          f" backend={'streamed' if backend is not None else 'device'}"
          f" cold={_cold_mode(args.cold)}"
          f" t_hashes={t.get('hashes')}"
          f" t_io={t.get('io')}"
          f" t_and={t.get('and rows')}"
          f" t_add={t.get('add rows')}"
          f" t_sort={t.get('sort results')}"
          f" t_total={elapsed}"
          f" queries_per_s={len(queries) / elapsed}")
    for score in sorted(counts):
        print(f"RESULT name=benchmark_fpr fpr={score} dist={counts[score]}")
    return 0


def _cold_mode(cold: bool) -> str:
    """Label the RESULT line with HOW cold was enforced: RWF_DONTCACHE
    reads never touch the page cache (stable by construction, the
    reference's O_DIRECT analog); the eviction fallback re-evicts per
    batch and is noisier."""
    if not cold:
        return "off"
    from cobs_tpu import native
    return ("on-dontcache" if native.dontcache_supported()
            else "on-evict")


def cmd_generate_queries(argv):
    p = argparse.ArgumentParser(prog="cobs generate-queries")
    p.add_argument("path", help="path to base documents")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    _add_threads_flag(p)
    p.add_argument("-k", "--term-size", type=int, default=31)
    p.add_argument("-p", "--positive", type=int, default=0)
    p.add_argument("-n", "--negative", type=int, default=0)
    p.add_argument("-N", "--true-negative", action="store_true")
    p.add_argument("-s", "--size", type=int, default=0,
                   help="extend positive terms with random data to size")
    p.add_argument("-S", "--seed", type=int, default=0)
    p.add_argument("-o", "--out-file", default="")
    args = p.parse_args(argv)
    _apply_threads(args)

    from cobs_tpu.ingest.document_list import DocumentList, \
        string_to_file_type
    from cobs_tpu.utils.misc import random_sequence_rng
    filelist = DocumentList(args.path, string_to_file_type(args.file_type))
    rng = np.random.default_rng(args.seed)

    term_size = args.term_size
    fixed_size = max(args.size, term_size)

    prefix = []
    total_terms = 0
    for e in filelist.list():
        prefix.append(total_terms)
        total_terms += e.num_terms(term_size)
    print(f"Given {filelist.size()} documents containing {total_terms} "
          f"{term_size}-gram terms", file=sys.stderr)

    if total_terms < args.positive:
        raise SystemExit("not enough terms for requested positives")

    positive_ids = set()
    while len(positive_ids) < args.positive:
        positive_ids.add(int(rng.integers(0, total_terms)))
    positive_ids = sorted(positive_ids)

    # negatives: random queries, optionally verified against the corpus
    negatives = [random_sequence_rng(fixed_size, rng)
                 for _ in range(int(1.5 * args.negative))]
    negative_terms: dict[bytes, list[int]] = {}
    for t_i, neg in enumerate(negatives):
        nb = neg.encode()
        for i in range(len(nb) - term_size + 1):
            negative_terms.setdefault(nb[i:i + term_size], []).append(t_i)

    queries = []  # (comment, sequence)
    pos_iter = iter(positive_ids)
    next_id = next(pos_iter, None)
    index = 0
    for d, e in enumerate(filelist.list()):
        doc_start = index
        for w in e.term_windows(term_size):
            n = w.shape[0]
            while next_id is not None and index <= next_id < index + n:
                term = w[next_id - index].tobytes()
                if fixed_size > term_size:
                    pad = fixed_size - term_size
                    front = int(rng.integers(0, pad))
                    term = (random_sequence_rng(front, rng).encode() + term
                            + random_sequence_rng(pad - front, rng).encode())
                queries.append((
                    f">doc:{d}:term:{next_id - doc_start}:{e.name}",
                    term.decode()))
                next_id = next(pos_iter, None)
            if args.true_negative:
                for row in w:
                    hit = negative_terms.pop(row.tobytes(), None)
                    if hit is not None:
                        for t_i in hit:
                            negatives[t_i] = ""
            index += n

    real_negatives = [x for x in negatives if x][:args.negative]
    if len(real_negatives) < args.negative:
        raise SystemExit(
            "Not enough true negatives left, you were unlucky, try again.")
    for i, neg in enumerate(real_negatives):
        queries.append((f">negative{i}", neg))

    order = rng.permutation(len(queries))
    out = sys.stdout if not args.out_file else open(args.out_file, "w")
    try:
        for i in order:
            comment, seq = queries[i]
            out.write(comment + "\n" + seq + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# ------------------------------------------------------------------ driver



def cmd_benchmark_scaling(argv):
    p = argparse.ArgumentParser(prog="cobs benchmark-scaling")
    p.add_argument("-n", "--num-devices", type=int, default=0,
                   help="devices to scale to (default: all)")
    p.add_argument("--docs-per-shard", type=int, default=4096)
    p.add_argument("--sig-size", type=int, default=1 << 18)
    p.add_argument("-b", "--batch", type=int, default=16)
    p.add_argument("--batch-sweep", type=str, default="",
                   help="comma-separated batch sizes to additionally "
                        "measure at full mesh width (batch size is the "
                        "serving lever; scaling claims must state B)")
    p.add_argument("--num-kmers", type=int, default=1000)
    p.add_argument("--iterations", type=int, default=10)
    args = p.parse_args(argv)

    from cobs_tpu.parallel.benchmark import benchmark_scaling
    sweep = tuple(int(x) for x in args.batch_sweep.split(",") if x)
    r = benchmark_scaling(
        n_devices=args.num_devices or None,
        sig_size=args.sig_size, docs_per_shard=args.docs_per_shard,
        B=args.batch, T=args.num_kmers, iters=args.iterations,
        B_sweep=sweep)
    for n, qps in sorted(r["per_n"].items()):
        print(f"RESULT devices={n} batch={args.batch} "
              f"queries_per_s={qps:.1f} "
              f"docs_per_query={n * args.docs_per_shard} "
              f"cpu_cores_busy={r['cpu_util'][n]:.2f}")
    for b, qps in sorted(r["per_b"].items()):
        print(f"RESULT batch_sweep B={b} queries_per_s={qps:.1f}")
    full = r["per_n"].get(args.num_devices or max(r["per_n"]))
    ratio = (f" vs_per_batch={r['mega_qps'] / full:.2f}"
             if full else "")
    print(f"RESULT mesh_mega batch={args.batch} K=8 "
          f"queries_per_s={r['mega_qps']:.1f}{ratio}")
    cm = r["cost_model"]
    print(f"RESULT cost_model hbm_bytes_per_query_per_shard="
          f"{cm['hbm_bytes_per_query_per_shard']} "
          f"collective_bytes_per_query="
          f"{cm['collective_bytes_per_query']} "
          f"broadcast_bytes_per_query="
          f"{cm['broadcast_bytes_per_query']} "
          f"cpu_proxy={cm['cpu_proxy']}")
    comp = r["compiled"]
    # artifact-level proof: collectives counted in the optimized HLO
    # of the scoring step, bytes from XLA's own cost analysis
    print(f"RESULT compiled hot_loop_collective_ops="
          f"{comp['collective_ops']} "
          f"bytes_accessed_per_query="
          f"{comp['bytes_accessed_per_query']:.0f}")
    if r["efficiency"] is not None:
        ratio = r["efficiency"] / r["predicted_efficiency"]
        print(f"RESULT weak_scaling_efficiency={r['efficiency']:.3f} "
              f"predicted={r['predicted_efficiency']:.3f} "
              f"measured_over_predicted={ratio:.3f}")
    return 0


SUBTOOLS = {
    "doc-list": (cmd_doc_list, "read a list of documents and print them"),
    "doc-dump": (cmd_doc_dump, "read a list of documents and dump their "
                               "terms"),
    "classic-construct": (cmd_classic_construct,
                          "construct a classic index from documents"),
    "classic-construct-random": (cmd_classic_construct_random,
                                 "construct a classic index with random "
                                 "data"),
    "compact-construct": (cmd_compact_construct,
                          "construct a compact index from documents"),
    "compact-construct-combine": (cmd_compact_construct_combine,
                                  "combine classic indices into a compact "
                                  "index"),
    "repack": (cmd_repack,
               "merge equal-size compact pages into wider pages, "
               "bit-preserving"),
    "query": (cmd_query, "query an index"),
    "serve": (cmd_serve, "run a resident batching query server"),
    "doctor": (cmd_doctor, "check devices, native runtime, caches"),
    "info": (cmd_info, "inspect an index file (header, geometry, "
                       "--scan statistics)"),
    "print-parameters": (cmd_print_parameters,
                         "print index parameters for a given configuration"),
    "print-kmers": (cmd_print_kmers,
                    "print canonicalized k-mers of a query"),
    "benchmark-scaling": (cmd_benchmark_scaling,
                          "measure multi-device weak-scaling efficiency"),
    "benchmark-fpr": (cmd_benchmark_fpr,
                      "run a false-positive-rate benchmark"),
    "generate-queries": (cmd_generate_queries,
                         "select queries randomly from documents"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("Usage: cobs <subtool> ...\n\nSubtools:")
        for name, (_fn, help_) in SUBTOOLS.items():
            print(f"  {name:28s} {help_}")
        return 0 if argv else -1
    name, rest = argv[0], argv[1:]
    if name not in SUBTOOLS:
        print(f"Unknown subtool '{name}'", file=sys.stderr)
        return -1
    from cobs_tpu.fmt.magic import FileIOError
    try:
        return SUBTOOLS[name][0](rest)
    except (ValueError, FileNotFoundError, FileExistsError,
            RuntimeError, FileIOError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def console_main() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    console_main()
