"""The overhead guards of the always-on telemetry, on the port's CPU world.

The JAX package's tier-1 guards (tests/test_opsplane.py, the flight
recorder; tests/test_critpath.py, the phase stamps), ported: the blocking
AddRows/GetRows round of a 8192 x 8 table with 512 ids must cost at most
``max(2%, 2 x the observed baseline noise)`` more with the instrument on
than off. Off and on worlds interleave and each side takes its best, so
scheduler jitter between worlds cannot fail a healthy build, and a failure
must reproduce on every retry (with a cool-down between them): a sustained
load patch under ``-n 6`` can straddle one attempt, a real regression past
the bar fails them all.

(1) the flight recorder: ``-mv_flight_events=4096`` (the default) against
    ``=0``, the phase stamps off on both sides (they have their own guard);
(2) the phase stamps: ``-mv_phase_stamps`` on (the default) against off.
"""

import time

import numpy as np
import torch

torch.set_num_threads(1)


def _measure(argv, seed):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    k, rounds = 512, 15
    rng = np.random.default_rng(seed)
    mv.MV_Init(["-mv_device=cpu"] + list(argv))
    try:
        table = mv.MV_CreateTable(MatrixTableOption(num_rows=8192,
                                                    num_cols=8))
        ids = rng.choice(8192, size=k, replace=False).astype(np.int32)
        deltas = rng.standard_normal((k, 8)).astype(np.float32)
        table.AddRows(ids, deltas)      # warm up
        table.GetRows(ids)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(rounds):
                table.AddRows(ids, deltas)
                table.GetRows(ids)
            best = min(best, time.perf_counter() - t0)
    finally:
        mv.MV_ShutDown()
    return best / rounds


def _guard(off_argv, on_argv, seed, worlds, attempts, what):
    last = None
    for _ in range(attempts):
        if last is not None:
            time.sleep(1.0)     # let a transient load spike pass
        offs, ons = [], []
        for _ in range(worlds):
            offs.append(_measure(off_argv, seed))
            ons.append(_measure(on_argv, seed))
        base, on = min(offs), min(ons)
        noise_pct = 100.0 * (max(offs) - base) / base
        overhead_pct = 100.0 * (on - base) / base
        allowed = max(2.0, 2.0 * noise_pct)
        if overhead_pct <= allowed:
            return
        last = (f"{what} overhead {overhead_pct:.2f}% exceeds "
                f"{allowed:.2f}% (baseline noise {noise_pct:.2f}%; "
                f"off={[round(o * 1e6) for o in offs]}us, "
                f"on={[round(o * 1e6) for o in ons]}us per round)")
    raise AssertionError(last)


def test_flight_recorder_overhead_within_2pct():
    _guard(["-mv_flight_events=0", "-mv_phase_stamps=0"],
           ["-mv_flight_events=4096", "-mv_phase_stamps=0"],
           seed=7, worlds=2, attempts=3, what="flight recorder")


def test_phase_stamp_overhead_within_budget():
    _guard(["-mv_phase_stamps=0"], [], seed=11, worlds=3, attempts=2,
           what="phase stamping")
