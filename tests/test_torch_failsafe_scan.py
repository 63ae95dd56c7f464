"""The bounded-blocking law of the JAX package's tests/test_failsafe.py,
written here for the port (the JAX package checks it with its analysis
framework, which the port does not have).

Every ``.wait()``, ``.join()``, ``.Wait()`` or ``.Join()`` call in
``multiverso_tpu_torch/`` must pass a bound (a positional argument or a
keyword that is not a literal ``None``) or carry an ``unbounded-ok:``
justification within the 3 lines above it; and the port's own blocking
primitives (``Waiter.Wait``, ``MtQueue.Pop``) take a ``timeout``.
"""

import ast
import inspect
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1] / "multiverso_tpu_torch"
JUSTIFY_WINDOW = 3


def _unbounded_calls(path: Path) -> list:
    """``(line, text)`` of each unbounded, unjustified call in ``path``."""
    src = path.read_text()
    lines = src.splitlines()
    out = []
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr.lower() in ("wait", "join")):
            continue
        bounds = [a for a in node.args
                  if not (isinstance(a, ast.Constant) and a.value is None)]
        bounds += [k for k in node.keywords
                   if not (isinstance(k.value, ast.Constant)
                           and k.value.value is None)]
        if bounds:
            continue
        lo = max(0, node.lineno - 1 - JUSTIFY_WINDOW)
        if any("unbounded-ok:" in ln for ln in lines[lo:node.lineno]):
            continue
        out.append((node.lineno, lines[node.lineno - 1].strip()))
    return out


def test_no_unbounded_wait_or_join_without_justification(tmp_path):
    files = sorted(PKG.rglob("*.py"))
    rel = {str(p.relative_to(PKG)) for p in files}
    # the walk covers the planes where a hidden block would hang a world
    for need in ("tables/base.py", "zoo.py", "api.py", "actor.py",
                 "sync/server.py", "parallel/allreduce.py",
                 "parallel/shm_wire.py", "parallel/tcp_wire.py",
                 "serving/frontend.py", "telemetry/watchdog.py",
                 "telemetry/ops.py", "failsafe/chaos.py"):
        assert need in rel, need
    found = [f"{p.relative_to(PKG.parent)}:{line}: {text}"
             for p in files for line, text in _unbounded_calls(p)]
    assert not found, ("unbounded blocking calls without a bound or an "
                       "'unbounded-ok:' justification:\n"
                       + "\n".join(found))
    # the scan catches a bare call, a spelled-out None and a call split
    # across lines; a bound, or a justification within 3 lines, passes
    probe = tmp_path / "probe.py"
    probe.write_text("a.wait()\nb.join(None)\nc.d.Wait(\n)\n"
                     "e.Join(timeout=None)\nf.wait(1.0)\ng.join(timeout=t)\n"
                     "# unbounded-ok: the reason\n\nh.wait()\n"
                     "x = 1\ny = 2\nz = 3\ni.Join()\n")
    assert [line for line, _ in _unbounded_calls(probe)] == [1, 2, 3, 5, 14]


def test_blocking_primitives_take_timeouts():
    from multiverso_tpu_torch.tables.base import MultiCall
    from multiverso_tpu_torch.utils.mt_queue import MtQueue
    from multiverso_tpu_torch.utils.waiter import Waiter
    assert "timeout" in inspect.signature(MtQueue.Pop).parameters
    assert "timeout" in inspect.signature(Waiter.Wait).parameters
    assert "deadline" in inspect.signature(MultiCall.Wait).parameters
    q = MtQueue()
    t0 = time.monotonic()
    assert q.Pop(timeout=0.05) == (False, None)
    assert not Waiter(1).Wait(0.05)
    assert time.monotonic() - t0 < 2.0
