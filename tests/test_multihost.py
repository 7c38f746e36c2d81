"""Multi-host validation: a real 2-process jax.distributed job.

Spawns two worker processes, each with 4 virtual CPU devices; the
global ("batch", "docs") mesh spans 8 devices across both processes,
the signature matrix is document-sharded across them, and both
processes must reproduce the exact single-device scores (see
multihost_worker.py). This exercises the actual cross-process runtime
(coordinator handshake, global device mesh, cross-process collectives)
that multi-host deployments use.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).parent.parent


def _run_two_process(worker: str, expect: str, extra_args=()):
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ,
               PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / worker),
         str(port), str(i), *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            # generous: under a full-suite run the host's cores are
            # oversubscribed and the coordinator handshake + two jit
            # compiles can take minutes (observed flake at 150 s)
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{out[-2000:]}"
        assert f"process {i}: {expect}" in out


def test_two_process_distributed_scores_exact():
    _run_two_process("multihost_worker.py", "multihost scores exact")


def test_two_process_construct_and_federate(tmp_path):
    """The multi-host construction driver on a real 2-process job:
    per-host shard construction, host-local + global-mesh federation,
    bit-exact with the single-index build."""
    _run_two_process("multihost_construct_worker.py",
                     "multihost construct+federation exact",
                     extra_args=(str(tmp_path),))
