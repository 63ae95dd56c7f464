"""The port's spans and counters of where the card's time goes, on the CPU.

(1) a tiny WordEmbedding run (``-device_pairs 1``) under ``-trace=true``
    records every ``we.*`` span: the training thread's nested under its
    ``we.train`` call, the loader's on the loader's own thread inside the
    call; with ``-trace`` off it records none;
(2) a whole-table Get is one ``cuda.fetch`` span carrying the bytes the
    device-to-host funnel copied, the reply's own: the snapshot is made
    in the logical layout before it leaves the device (a momentum table:
    on the CPU an add or sgd table is served by the native host store,
    which has no funnel);
    ``cuda.d2h_bytes`` grows by them on the card and stays put on the
    CPU, where nothing left a device;
(3) ``engine.cpu_s`` grows across engine windows;
(4) every flow pair (``flow_start`` at a worker's enqueue, ``flow_end`` at
    the engine's dequeue) gives a wait of 0 or more;
(5) ``trace.profiler_ns`` puts a span stamp and a ``torch.profiler``
    record taken back to back within a millisecond, and
    ``trace.profiler_thread`` gives the record's thread key.
"""

import threading
import time

import numpy as np
import pytest
import torch

from multiverso_tpu_torch import api as mv
from multiverso_tpu_torch.tables import MatrixTableOption
from multiverso_tpu_torch.telemetry import metrics, trace

WE_SPANS = {"we.train", "we.loader_wait", "we.block", "we.lanes",
            "we.batch", "we.harvest", "we.loader.tokenize",
            "we.loader.make_block"}
LOADER_SPANS = {"we.loader.tokenize", "we.loader.make_block",
                "we.loader.push_wait"}


def _spans(name_prefix: str = "") -> list:
    return [e for e in trace.to_chrome_trace()["traceEvents"]
            if e.get("ph") == "X" and e["name"].startswith(name_prefix)]


def _counter(name: str) -> float:
    return metrics.snapshot().get(name, {}).get("value", 0.0)


def _we_run(tmp_path, traced: bool) -> list:
    from multiverso_tpu_torch.models.wordembedding.distributed import \
        DistributedWordEmbedding
    from multiverso_tpu_torch.models.wordembedding.option import Option
    rng = np.random.default_rng(3)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(
        " ".join(f"w{i}" for i in rng.integers(0, 40, 12))
        for _ in range(200)) + "\n")
    opt = Option(train_file=str(corpus),
                 output_file=str(tmp_path / "vec.txt"), embedding_size=8,
                 window_size=2, negative_num=2, min_count=1, epoch=2,
                 data_block_size=4000, pair_batch_size=256,
                 use_adagrad=True, init_learning_rate=0.1,
                 device_pairs=True, platform="cpu")
    mv.MV_Init(["-mv_device=cpu", f"-trace={str(traced).lower()}"])
    trace.clear()
    try:
        we = DistributedWordEmbedding(opt)
        try:
            we.prepare()
            we.train()
        finally:
            we.close()
        assert we.dp_trainer.batches > 1 and len(we.block_log) > 1
        return _spans("we.")
    finally:
        mv.MV_ShutDown()


def test_we_spans_nest_under_the_train_call_and_stay_off(tmp_path):
    assert _we_run(tmp_path, traced=False) == []
    spans = _we_run(tmp_path, traced=True)
    assert WE_SPANS <= {s["name"] for s in spans}
    assert {s["name"] for s in spans} <= WE_SPANS | LOADER_SPANS
    (call,) = [s for s in spans if s["name"] == "we.train"]
    by_id = {s["args"]["span_id"]: s for s in spans}
    t0, t1 = call["ts"], call["ts"] + call["dur"]
    for s in spans:
        assert t0 <= s["ts"] and s["ts"] + s["dur"] <= t1 + 1.0, s["name"]
        if s["name"] in LOADER_SPANS:
            assert s["tid"] != call["tid"], s["name"]
            continue
        assert s["tid"] == call["tid"], s["name"]
        # up the parent chain on the training thread to the call
        up = s
        while up["name"] != "we.train":
            up = by_id[up["args"]["parent_id"]]
        assert up is call, s["name"]
    parents = {s["name"]: by_id[s["args"]["parent_id"]]["name"]
               for s in spans if s["name"] not in LOADER_SPANS | {"we.train"}}
    assert parents["we.batch"] == "we.block"
    assert parents["we.lanes"] == "we.block"
    assert parents["we.loader_wait"] == "we.train"
    assert call["tid"] == threading.get_ident()
    assert trace.to_chrome_trace()["dropped"] == 0


def _whole_get(device: str) -> tuple:
    """A momentum table's whole-table Get on ``device``: (the reply's
    bytes, the ``cuda.d2h_bytes`` growth, the ``cuda.fetch`` spans'
    bytes)."""
    mv.MV_Init([f"-mv_device={device}", "-trace=true"])
    try:
        t = mv.MV_CreateTable(MatrixTableOption(num_rows=37, num_cols=5,
                                                updater_type="momentum"))
        t.AddRows(np.array([1, 30], np.int32), np.ones((2, 5), np.float32))
        trace.clear()
        before = _counter("cuda.d2h_bytes")
        whole = t.Get()
        grown = _counter("cuda.d2h_bytes") - before
        fetched = [f["args"]["bytes"] for f in _spans("cuda.fetch")]
    finally:
        mv.MV_ShutDown()
    assert whole.shape == (37, 5) and np.count_nonzero(whole) == 10
    return whole.nbytes, grown, fetched


@pytest.mark.cuda
def test_a_whole_get_on_the_card_grows_the_d2h_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: nothing leaves a device on the "
                    "CPU")
    copied, grown, fetched = _whole_get("cuda")
    assert grown == copied and fetched == [copied]


def test_copy_bytes_engine_cpu_and_flow_waits():
    """(2), (3) and (4) in one world each."""
    copied, grown, fetched = _whole_get("cpu")
    assert fetched == [copied] and grown == 0
    mv.MV_Init(["-mv_device=cpu", "-trace=true"])
    try:
        m = mv.MV_CreateTable(MatrixTableOption(num_rows=64, num_cols=8))
        ids = np.arange(8, dtype=np.int32)
        cpu = []
        trace.clear()

        def work():
            for _ in range(10):
                m.AddRows(ids, np.ones((8, 8), np.float32))
                m.GetRows(ids)

        for _ in range(3):
            threads = [threading.Thread(target=work) for _ in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            cpu.append(_counter("engine.cpu_s"))
        events = trace.to_chrome_trace()["traceEvents"]
    finally:
        mv.MV_ShutDown()
    assert 0 < cpu[0] < cpu[1] < cpu[2]
    starts, waits = {}, []
    for e in sorted((e for e in events if e.get("cat") == "msg"),
                    key=lambda e: e["ts"]):
        if e["ph"] == "s":
            starts.setdefault(e["id"], []).append(e["ts"])
        elif starts.get(e["id"]):
            waits.append(e["ts"] - starts[e["id"]].pop(0))
    assert len(waits) >= 180
    assert min(waits) >= 0.0


def test_profiler_clock_map_holds_back_to_back():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stamps = []
        for i in range(3):
            stamps.append(time.perf_counter() * 1e6)
            with record_function(f"clock_probe{i}"):
                pass
    clock = trace.to_chrome_trace()["clock"]
    recs = sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("clock_probe")),
                  key=lambda e: e.name())
    assert len(recs) == 3
    for ts, rec in zip(stamps, recs):
        assert abs(trace.profiler_ns(ts, clock) - rec.start_ns()) < 1e6
    ident = threading.get_ident()
    key = trace.profiler_thread(ident)
    assert -(1 << 31) <= key < (1 << 31)
    assert key & 0xFFFFFFFF == ident & 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
