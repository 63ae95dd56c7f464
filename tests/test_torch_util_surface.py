"""The rest of the JAX public surface in the port, held to the JAX
package's behaviour on the same inputs.

(a) The logger: a ``Logger`` with a file sink, its level, ``Write``,
    errors mirrored to stderr, ``-logtostderr`` (registered in each
    package's own registry), ``CHECK_NOTNULL``, ``FatalError`` by default
    and the process's end under ``ResetKillFatal(True)``, each run in an
    interpreter of its own for both packages: the same lines (stamps
    aside) and the same exit codes.
(b) ``TextReader``, ``HasFlag``, ``MtQueue.Front``/``Empty``/``alive``,
    ``Waiter.Reset``, ``message.to_*``, ``Node.is_worker``,
    ``seal_frame_legacy`` (each package opens the other's blob),
    ``native.crc32c_fn``, ``flight.last_detail``, ``decode_window``,
    ``row_partition_server``, ``broadcast_from_master`` and
    ``union_collective_ids`` in a one-process world and over a
    two-member elastic group (a stand-in whose exchange returns the
    members' blobs).
"""

import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_LOG_SCRIPT = r'''
import sys
pkg, path, mode = sys.argv[1:4]
if pkg == "jax":
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    from multiverso_tpu.utils import configure, log
else:
    from multiverso_tpu_torch.utils import configure, log
lg = log.Logger(log.LogLevel.Info, path)
lg.Debug("hidden %d", 1)
lg.Info("info %s", "a")
lg.Error("error %d", 2)
lg.ResetLogLevel(log.LogLevel.Debug)
lg.Write(log.LogLevel.Debug, "debug %d", 3)
assert configure.HasFlag("logtostderr") and not configure.HasFlag("nope")
configure.SetCMDFlag("logtostderr", True)
lg.Info("to stderr")
configure.SetCMDFlag("logtostderr", False)
assert log.CHECK_NOTNULL(5, "x") == 5
try:
    log.CHECK_NOTNULL(None, "thing")
except log.FatalError as e:
    print("fatal:", e)
lg.ResetLogFile("")
log.Log.ResetLogLevel(log.LogLevel.Error)
log.Log.Info("static hidden")
log.Log.Error("static error")
if mode == "kill":
    log.Log.ResetKillFatal(True)
    log.CHECK(False, "dies")
print("end")
'''


def _strip(text: str) -> list:
    """Lines with the time stamp cut out."""
    out = []
    for line in text.splitlines():
        if line.startswith("[") and "] [" in line:
            head, rest = line.split("] [", 1)
            line = head + "] " + rest.split("] ", 1)[1]
        out.append(line)
    return out


def _log_run(pkg, tmp_path, mode):
    path = tmp_path / f"{pkg}_{mode}.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-c", _LOG_SCRIPT, pkg, str(path),
                        mode], capture_output=True, text=True, env=env,
                       timeout=120)
    return p.returncode, p.stdout, _strip(p.stderr), _strip(path.read_text())


def test_logger_matches_jax(tmp_path):
    for mode in ("plain", "kill"):
        jax = _log_run("jax", tmp_path, mode)
        port = _log_run("torch", tmp_path, mode)
        assert port == jax, mode
    rc, out, err, filed = port
    assert rc == 1 and "end" not in out                # the process ended
    assert "fatal: Check notnull failed: thing" in out
    assert filed == ["[INFO] info a", "[ERROR] error 2", "[DEBUG] debug 3"]
    assert "[INFO] to stderr" in err and "[ERROR] error 2" in err
    assert "[FATAL] Check notnull failed: thing" in err
    assert "[ERROR] static error" in err and "[INFO] static hidden" not in err
    assert err[-1] == "[FATAL] Check failed: dies"
    rc, out, _, _ = _log_run("torch", tmp_path, "plain")
    assert rc == 0 and out.splitlines()[-1] == "end"


def _utils(pkg):
    if pkg == "jax":
        from multiverso_tpu import message, node
        from multiverso_tpu import native as nat
        from multiverso_tpu.parallel import mesh, multihost, seal, wire
        from multiverso_tpu.telemetry import flight
        from multiverso_tpu.utils import io, mt_queue, waiter
    else:
        from multiverso_tpu_torch import message, node
        from multiverso_tpu_torch import native as nat
        from multiverso_tpu_torch.parallel import (mesh, multihost, seal,
                                                   wire)
        from multiverso_tpu_torch.telemetry import flight
        from multiverso_tpu_torch.utils import io, mt_queue, waiter
    return dict(message=message, node=node, nat=nat, mesh=mesh,
                multihost=multihost, seal=seal, wire=wire, flight=flight,
                io=io, mt_queue=mt_queue, waiter=waiter)


def _walk(m, tmp_path):
    """What each piece observes, as plain values."""
    rec = {}
    path = tmp_path / "lines.txt"
    path.write_text("alpha\nbeta gamma\n\nlast")
    with m["io"].TextReader(str(path), buf_size=4) as r:
        lines = []
        while (line := r.GetLine()) is not None:
            lines.append(line)
    rec["lines"] = lines
    q = m["mt_queue"].MtQueue()
    rec["q0"] = (q.Empty(), q.alive, q.Front(timeout=0.01))
    q.Push(7)
    q.Push(8)
    rec["q1"] = (q.Empty(), q.Front(), q.Size(), q.Pop(), q.Size())
    threading.Timer(0.05, lambda: q.Push(9)).start()
    rec["q2"] = (q.Pop(), q.Front(timeout=5))
    q.Exit()
    rec["q3"] = (q.alive, q.Front(), q.Pop(), q.Pop(timeout=0.01))
    w = m["waiter"].Waiter(1)
    w.Notify()
    rec["w0"] = w.Wait(timeout=0)
    w.Reset(2)
    w.Notify()
    rec["w1"] = w.Wait(timeout=0.01)
    threading.Timer(0.05, w.Notify).start()
    rec["w2"] = w.Wait(timeout=5)
    msg = m["message"]
    rec["to"] = [(t, msg.to_server(t), msg.to_worker(t),
                  msg.to_controller(t)) for t in range(-40, 41)]
    node = m["node"]
    rec["roles"] = [(n.is_worker(), n.is_server()) for n in
                    (node.Node(role=r) for r in node.Role)]
    rec["parts"] = [m["mesh"].row_partition_server(r, 10, s)
                    for r in range(10) for s in (1, 3, 4, 11)]
    body = bytes(range(256)) * 9
    rec["legacy"] = m["seal"].seal_frame_legacy(body)
    rec["crc"] = m["nat"].crc32c(body, 7)
    m["flight"].record("surface.kind", detail="first")
    m["flight"].record("surface.kind", detail="second")
    m["flight"].record("surface.other", detail="x")
    rec["last"] = (m["flight"].last_detail("surface.kind"),
                   m["flight"].last_detail("surface.never"))
    return rec


def test_surface_pieces_match_jax(tmp_path, monkeypatch):
    jm, tm = _utils("jax"), _utils("torch")
    jrec, trec = _walk(jm, tmp_path), _walk(tm, tmp_path)
    assert trec == jrec
    assert trec["lines"] == ["alpha", "beta gamma", "", "last"]
    assert trec["q3"] == (False, (True, 9), (True, 9), (False, None))
    assert trec["w0"] and not trec["w1"] and trec["w2"]
    # each package opens the other's legacy blob; the crc entry points
    body = bytes(range(256)) * 9
    assert tm["seal"].open_frame(jrec["legacy"]) == body
    assert jm["seal"].open_frame(trec["legacy"]) == body
    assert tm["nat"].crc32c_fn() is not None
    arr = np.frombuffer(body, np.uint8)
    assert int(tm["nat"].crc32c_fn()(arr.ctypes.data, arr.size, 7)) == \
        trec["crc"]
    assert int(tm["nat"].crc32c_charp_fn()(body, len(body), 7)) == \
        trec["crc"]
    # a window blob decodes to its verbs in both packages
    verbs = [("a", 1, {"row_ids": np.arange(3, dtype=np.int32)})]
    blob = tm["wire"].encode_window(verbs, 5)
    for m in (jm, tm):
        got = m["wire"].decode_window(blob)
        assert [(k, t) for k, t, _ in got] == [("a", 1)]
        np.testing.assert_array_equal(got[0][2]["row_ids"], np.arange(3))
    # one process: the identity; a two-member elastic group: the
    # lowest member's value, and the members' union
    mh = tm["multihost"]
    data = np.array([3.0, 4.0])
    assert mh.broadcast_from_master(data) is data
    assert mh.union_collective_ids(np.array([1, 2])) is None

    class Pair:
        """Two members; this process is rank 1 (the peer's blob first)."""
        size = 2

        def __init__(self):
            self.keys = []

        def rank(self):
            return 1

        def exchange(self, blob, key):
            self.keys.append(key)
            peer = pickle.loads(blob)
            peer = (peer - 100) if peer.dtype.kind == "f" else peer + 10
            return [pickle.dumps(peer), blob]

    pair = Pair()
    monkeypatch.setattr(mh, "_group", pair)
    got = mh.broadcast_from_master(data)
    np.testing.assert_array_equal(got, data - 100)
    np.testing.assert_array_equal(
        mh.union_collective_ids(np.array([5, 1, 5])),
        np.array([1, 5, 11, 15]))
    assert pair.keys == ["HAB", "HAB"]
