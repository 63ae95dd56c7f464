"""Each engine shard reads the timing of its OWN window exchange.

A sharded engine across processes runs one exchange per shard at the same
time, each on its own thread and wire channel. The engine splits a
window's exchange wall (``window.phases`` ``x``) from the seconds blocked
in the collective (``xw``, summed into the shard's ``xw_busy_s``) with
``multihost.last_exchange_stats()``, read on the thread that exchanged.

(1) Two threads on a stand-in wire, one exchange blocked for 0.3 s on
    channel 0 and one immediate on channel 1: the immediate one, read
    after the slow one ended, still sees its own collective seconds.
(2) A two-rank world of ``tests/_mh_child.py`` mode ``telemetry`` at
    ``-mv_engine_shards=2`` (four tables on two shards, fire-and-forget
    bursts on both): on every rank and shard, each window's ``xw`` is at
    most its ``x``, and the shard's ``xw_busy_s`` is at most the sum of
    its own windows' exchange walls.
"""

import glob
import json
import threading
import time
from collections import defaultdict

from tests._mh_worlds import run_world


class _SlowWire:
    """A host wire whose channel 0 blocks until released."""

    def __init__(self):
        self.release = threading.Event()

    def exchange(self, blob, channel, timeout_s=None):
        if channel == 0:
            assert self.release.wait(10)
            time.sleep(0.3)
        return [blob, blob]


def test_exchange_stats_are_per_thread(monkeypatch):
    from multiverso_tpu_torch.parallel import multihost
    wire = _SlowWire()
    monkeypatch.setattr(multihost, "_wire", wire)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "_rounds", multihost._rounds)
    seen, slow_done = {}, threading.Event()

    def slow():
        t0 = time.perf_counter()
        multihost.capped_exchange(b"a", {}, 0, channel=0)
        seen["slow_wall"] = time.perf_counter() - t0
        seen["slow"] = dict(multihost.last_exchange_stats())
        slow_done.set()

    def fast():
        t0 = time.perf_counter()
        multihost.capped_exchange(b"b", {}, 0, channel=1)
        seen["fast_wall"] = time.perf_counter() - t0
        wire.release.set()
        assert slow_done.wait(10)
        # read only after the other thread's exchange ended
        seen["fast"] = dict(multihost.last_exchange_stats())

    threads = [threading.Thread(target=f) for f in (slow, fast)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert seen["slow"]["coll_s"] >= 0.3
    assert seen["slow"]["coll_s"] <= seen["slow_wall"]
    assert seen["fast"]["coll_s"] <= seen["fast_wall"] < 0.3
    assert seen["fast"]["done_m"] < seen["slow"]["done_m"]
    # a thread that never exchanged reads zeros
    out = []
    t = threading.Thread(
        target=lambda: out.append(multihost.last_exchange_stats()))
    t.start()
    t.join(10)
    assert out[0]["coll_s"] == 0.0 and out[0]["done_w"] == 0.0


def _window_phases(path):
    """stream -> [(x us, xw us)] of the dump's window.phases events."""
    from multiverso_tpu_torch.telemetry import critpath
    out = defaultdict(list)
    with open(path) as f:
        # every window of the run is in the ring
        assert json.loads(f.readline())["dropped"] == 0
        for line in f:
            ev = json.loads(line)
            if ev.get("kind") != "window.phases":
                continue
            d = critpath._parse_detail(ev.get("detail", ""))
            if "x" in d:
                out[int(ev.get("stream", 0))].append(
                    (d["x"], d.get("xw", 0.0)))
    return out


def test_sharded_engine_shards_read_their_own_exchange(tmp_path):
    diag = tmp_path / "diag"
    res, _ = run_world("torch", "telemetry", tmp_path,
                       "-mv_engine_shards=2", f"-mv_diag_dir={diag}",
                       timeout=240)
    for r in range(2):
        paths = glob.glob(str(diag / f"flight_rank{r}.jsonl"))
        assert len(paths) == 1
        phases = _window_phases(paths[0])
        streams = [int(s) for s in res[r]["xw_stream"]]
        assert sorted(streams) == [0, 1]
        for stream, xw_busy in zip(streams, res[r]["xw_busy_s"]):
            wins = phases[stream]
            assert wins, (r, stream)
            for x_us, xw_us in wins:
                assert xw_us <= x_us, (r, stream, x_us, xw_us)
            # the event's integer microseconds truncate: one per window
            wall_s = (sum(x for x, _ in wins) + len(wins)) * 1e-6
            assert float(xw_busy) <= wall_s, (r, stream, xw_busy, wall_s)
