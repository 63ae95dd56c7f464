"""Launch both ranks of a two-process world of ``tests/_mh_child.py`` and
collect what each rank saved (tests/test_torch_multihost.py,
tests/test_torch_windowed.py).

Free ports are picked as tests/test_multihost.py picks them: bind port 0
on 127.0.0.1, read the port, close. Every child runs under a wall-clock
limit; a child that hangs past it fails the test (and both ranks are
killed), and the port's children also bound every collective by
``-mv_dist_timeout_s=60``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "_mh_child.py"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _libpath() -> str:
    from multiverso_tpu_torch import native
    path = native.build()
    return "" if path is None else str(path)


def run_world(pkg: str, mode: str, outdir, *extra, ok_ranks=(0, 1),
              timeout: int = 120, port=None):
    """Both ranks of ``mode`` on package ``pkg`` ("jax" or "torch");
    returns (the saved results of each rank in ``ok_ranks``, every rank's
    output). Each rank in ``ok_ranks`` must exit 0 with its OK line."""
    port = port or free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), pkg, mode, str(r), str(port),
         str(outdir), _libpath(), *[str(a) for a in extra]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"{pkg} {mode}: a rank hung past {timeout} s:\n"
                        f"{out[-3000:]}")
        outs.append(out)
    for r in ok_ranks:
        assert procs[r].returncode == 0, \
            f"{pkg} {mode} rank {r} failed:\n{outs[r][-3000:]}"
        assert f"child {r} {mode} OK" in outs[r], outs[r][-3000:]
    return [dict(np.load(Path(outdir) / f"{pkg}_{mode}_{r}.npz"))
            for r in ok_ranks], outs
