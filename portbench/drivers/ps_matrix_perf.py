"""Driver of ``ps_matrix_perf``: the reference's ``test_matrix_perf``
table (a 1,000,000 x 50 float32 MatrixTable, ``add`` updater) driven by
worker threads through the worker verbs ``AddRows``, ``GetRows`` and
``Get``, on the default engine and write-combine settings.

Closed loop: each worker starts its next round when the last returned.
A round is the workload's ``round``, a list of verbs run in order on the
round's ids: ``AddRows`` (a blocking add of the deltas), ``GetRows`` (the
round's ids) or ``Get`` (the whole table). Every worker writes only rows
of its own, so each Get has one right answer; a sample of the rounds
drawn from the seed keeps what its Gets returned (the whole result of a
GetRows, the worker's own rows of a Get), and after the window the plain
reference replays every worker's rounds and compares them, and the final
table, element by element.
"""

from __future__ import annotations

import os
import resource
import threading
import time
from pathlib import Path

from portbench.lib import core, traffic

REF = core.load_module(Path(__file__).resolve().parents[1] / "reference"
                       / "ps_matrix_perf.py", "portbench_reference_ps")

JOIN_S = 300


def counters() -> dict:
    from multiverso_tpu_torch import api as mv
    snap = mv.MV_MetricsSnapshot()
    win = snap.get("server.window.latency_s", {})
    return {"windows": float(win.get("count", 0.0)),
            "window_s": float(win.get("sum", 0.0)),
            "verbs": float(snap.get("server.window.verbs", {})
                           .get("value", 0.0))}


def thread_cpu_s() -> dict:
    """CPU seconds of each live thread of this process, by thread name
    (``/proc/self/task/<tid>/stat``)."""
    hz = float(os.sysconf("SC_CLK_TCK"))
    out = {}
    for th in threading.enumerate():
        try:
            with open(f"/proc/self/task/{th.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, TypeError):
            continue
        out[th.name] = (int(fields[11]) + int(fields[12])) / hz
    return out


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, workdir: str,
                 device: str):
        import torch
        from multiverso_tpu_torch import api as mv
        from multiverso_tpu_torch.tables import MatrixTableOption
        from multiverso_tpu_torch.zoo import Zoo
        self.torch, self.mv, self.zoo = torch, mv, Zoo
        self.cfg, self.params, self.seed, self.device = (cfg, params, seed,
                                                         device)
        unknown = set(params["round"]) - set(REF.VERBS)
        if unknown:
            raise ValueError(f"unknown verbs in the round: {unknown}")
        W = params["workers"]
        self.pools = [traffic.ps_pool(seed, w, cfg, params) for w in range(W)]
        self.sample = [traffic.ps_sample(seed, w, params["sample_every"])
                       for w in range(W)]
        self.own = [traffic.own_rows(cfg["num_rows"], W, w) for w in range(W)]
        self.rounds = [0] * W
        self.kept = [{} for _ in range(W)]
        mv.MV_Init([f"-num_workers={W}", f"-mv_device={device}"])
        self.up = True
        try:
            self.table = mv.MV_CreateTable(MatrixTableOption(
                num_rows=cfg["num_rows"], num_cols=cfg["num_cols"],
                updater_type=cfg["updater_type"]))
            # warm-up: one round per worker (round 0, kept and checked)
            self._run_workers(lambda w: self._round(w, None), W)
        except BaseException:
            self.close()
            raise

    def _round(self, w: int, stamps) -> None:
        """Worker ``w``'s next round; appends the host clock before the
        first verb and after each verb to ``stamps``."""
        i = self.rounds[w]
        ids, d = self.pools[w][i % len(self.pools[w])]
        keep = self.sample[w][i % len(self.sample[w])]
        lo, hi = self.own[w]
        t, got = self.table, []
        ts = [time.perf_counter()]
        for verb in self.params["round"]:
            if verb == "AddRows":
                t.AddRows(ids, d)
            elif verb == "GetRows":
                rows = t.GetRows(ids)
                if keep:
                    got.append(rows)
            else:
                whole = t.Get()
                if keep:
                    got.append(whole[lo:hi].copy())
            ts.append(time.perf_counter())
        if keep:
            self.kept[w][i] = got
        if stamps is not None:
            stamps.append(ts)
        self.rounds[w] = i + 1

    def _run_workers(self, body, n: int) -> None:
        errors = []

        def guarded(w):
            try:
                with self.zoo.Get().worker_context(w):
                    body(w)
            except BaseException as exc:        # re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=guarded, args=(w,))
                   for w in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(JOIN_S)
        if any(th.is_alive() for th in threads):
            raise RuntimeError(f"a worker thread hung past {JOIN_S} s")
        if errors:
            raise errors[0]

    def window(self, seconds: float, phases) -> dict:
        W = self.params["workers"]
        lats = [[] for _ in range(W)]
        worker_cpu = [0.0] * W
        start = threading.Barrier(W + 1)
        t_end = [0.0]
        c0, cpu0 = counters(), thread_cpu_s()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)

        def body(w):
            start.wait()
            c = time.thread_time()
            while time.perf_counter() < t_end[0]:
                self._round(w, lats[w])
            worker_cpu[w] = time.thread_time() - c

        runner = threading.Thread(target=self._run_workers, args=(body, W))
        runner.start()
        t_start = time.perf_counter()
        t_end[0] = t_start + seconds
        start.wait()
        runner.join()
        if self.device == "cuda":
            self.torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        c1, cpu1 = counters(), thread_cpu_s()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        verbs = self.params["round"]
        round_ms = []
        per_5s = [0] * (int(wall // 5) + 1)
        for lat in lats:
            for ts in lat:
                for k, verb in enumerate(verbs):
                    phases.add(f"ps.{verb}", ts[k], ts[k + 1])
                round_ms.append((ts[-1] - ts[0]) * 1e3)
                per_5s[min(int((ts[-1] - t_start) // 5), len(per_5s) - 1)] += 1
        n = len(round_ms)
        windows = c1["windows"] - c0["windows"]
        diag = {"rounds_per_s": n / wall, "windows": windows,
                "verbs_per_window": (c1["verbs"] - c0["verbs"])
                / max(windows, 1.0),
                "engine_ms_per_window": (c1["window_s"] - c0["window_s"])
                / max(windows, 1.0) * 1e3,
                "worker_cpu_s": [round(c, 3) for c in worker_cpu],
                "thread_cpu_s": {k: round(v - cpu0.get(k, 0.0), 2)
                                 for k, v in cpu1.items()
                                 if v - cpu0.get(k, 0.0) > 0.05},
                "process_cpu_s": (ru1.ru_utime + ru1.ru_stime
                                  - ru0.ru_utime - ru0.ru_stime),
                "rounds_per_5s": per_5s}
        return {"attempted": n, "failed": 0, "window_s": wall, "diag": diag,
                "ps": {"round": verbs, "rounds": n, "round_ms": round_ms,
                       "windows": windows,
                       "engine_window_s": c1["window_s"] - c0["window_s"],
                       "verbs": c1["verbs"] - c0["verbs"],
                       "ids_per_round": self.params["ids_per_round"],
                       "cols": self.cfg["num_cols"]}}

    def per_layer(self, rec: dict) -> None:
        pass

    def verify(self) -> dict:
        final = self.table.Get()
        self._shutdown()
        cfg, limits = self.cfg, self.params["limits"]
        ref, bad_gets = REF.replay(
            cfg["num_rows"], cfg["num_cols"], self.pools, self.rounds,
            self.kept, self.params["round"], self.own,
            self.torch.device(self.device))
        bad_final = int((final != ref).sum())
        return {"gets_differ": {"value": float(bad_gets),
                                "limit": limits["gets_differ"]},
                "table_differs": {"value": float(bad_final),
                                  "limit": limits["table_differs"]}}

    def _shutdown(self) -> None:
        if self.up:
            self.up = False
            self.mv.MV_ShutDown()
            if self.device == "cuda":
                self.torch.cuda.empty_cache()

    def close(self) -> None:
        self._shutdown()
