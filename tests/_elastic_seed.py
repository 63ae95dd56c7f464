"""The seeded fleet rollups of the fleet parity tests, shared by
``tests/_elastic_child.py`` (either package, in its own interpreter) and
``tests/test_torch_fleet.py``."""

import numpy as np


def fleet_rollups(fleet_mod, metrics_mod):
    """Seeded rollups: four members, each a digest of request latencies
    (member 3 slow, member 2 serving little) at two arrival times."""
    rng = np.random.default_rng(17)
    rollups = []
    for tick in range(2):
        for m in range(4):
            d = metrics_mod.Digest(f"digest.worker.rtt_s.{m}")
            scale = 0.05 if m == 3 else 0.002
            n = 40 if m == 2 else 400 * (tick + 1)
            for v in rng.exponential(scale, n):
                d.observe(float(v))
            sv = metrics_mod.Digest("digest.serving.latency_s")
            for v in rng.exponential(0.001, 10 * (tick + 1)):
                sv.observe(float(v))
            rollups.append({
                "v": fleet_mod.ROLLUP_V, "member": f"rank{m}",
                "role": "trainer",
                "ops": float(d._vector()[0] + sv._vector()[0]),
                "digests": {"digest.worker.rtt_s":
                            np.asarray(d._vector(), np.float64),
                            "digest.serving.latency_s":
                            np.asarray(sv._vector(), np.float64)},
                "gauges": {"mem.total_bytes": float(1000 * m)}})
    return rollups
