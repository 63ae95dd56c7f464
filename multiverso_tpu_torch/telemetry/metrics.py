"""Typed metrics registry: Counter / Gauge / log-bucketed Histogram /
mergeable Digest (the port's own copy of the JAX package's
``telemetry/metrics.py``: the same ladder, encodings and merge laws, so a
snapshot of either package renders byte-equal).

Prometheus-style instruments for the runtime's hot paths, designed
around the two constraints the Dashboard already solved partially:

* **threads** — worker threads and the engine actor update instruments
  concurrently; every mutation is a short critical section.
* **hosts** — a multi-process job wants job-wide totals, but collective
  reduces require every rank to agree on buffer shape. Instrument
  *names* are exchanged first and the reduce runs over the union
  (the ``Dashboard.AggregateAcrossHosts`` trick), and every instrument
  encodes to a FIXED-width float vector — counters/gauges to one slot,
  histograms to ``N_BUCKETS + 2`` (count, sum, buckets) — so the one
  allreduce always agrees on shape even when rank A observed a
  histogram rank B never touched.

Histogram buckets are a fixed geometric ladder (powers of two from
``2**_MIN_EXP``): bucket ``i`` holds values in ``(2**(_MIN_EXP+i-1),
2**(_MIN_EXP+i)]``. One ladder serves seconds (~1us resolution) and
bytes alike, and because the ladder is a compile-time constant, bucket
vectors from different hosts add elementwise — which is exactly what
the cross-host merge does. Percentiles interpolate linearly inside the
winning bucket, so p50/p90/p99 are estimates with <= one-octave error,
the standard log-bucket tradeoff.

The ``-telemetry`` flag gates the whole layer: when false, instrument
lookups return one shared no-op ``NULL`` instrument and the registry
stays empty (the off fast path allocates nothing; tests assert this).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List

from multiverso_tpu_torch.utils.configure import MV_DEFINE_bool, cached_bool_flag
from multiverso_tpu_torch.utils.log import CHECK

MV_DEFINE_bool("telemetry", True,
               "typed metrics registry (counters/gauges/histograms) on/off")

#: the -telemetry gate, CACHED behind a flag listener: GetFlag walks
#: the typed registries under their lock — too costly per message
enabled = cached_bool_flag("telemetry", True)

#: fixed histogram ladder: bucket i's upper bound is 2**(_MIN_EXP + i).
#: 64 octaves from ~1e-6 (1us / 1 byte-ish) to ~8.8e12 cover every
#: latency and byte quantity the runtime observes.
N_BUCKETS = 64
_MIN_EXP = -20
#: fixed vector widths per instrument kind — the cross-host merge
#: contract (every rank derives the same layout from (name, kind))
_WIDTHS = {"c": 1, "g": 1, "m": 1, "h": N_BUCKETS + 2,
           "d": N_BUCKETS + 4}




def bucket_index(v: float) -> int:
    """Ladder bucket for ``v``: smallest i with v <= 2**(_MIN_EXP+i),
    clamped to [0, N_BUCKETS). Non-positive values land in bucket 0."""
    if v <= 0:
        return 0
    m, e = math.frexp(v)          # v = m * 2**e, 0.5 <= m < 1 — exact
    ce = e - 1 if m == 0.5 else e  # ceil(log2(v)) without float log
    return min(max(ce - _MIN_EXP, 0), N_BUCKETS - 1)


def bucket_bounds(i: int):
    """(lower, upper] value bounds of bucket ``i`` (lower of bucket 0
    is 0 — it also absorbs non-positive observations)."""
    lo = 0.0 if i == 0 else 2.0 ** (_MIN_EXP + i - 1)
    return lo, 2.0 ** (_MIN_EXP + i)


class _Null:
    """Shared no-op instrument handed out when telemetry is off; every
    mutator is a pass so cached handles stay valid either way."""

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0


NULL = _Null()


class Counter:
    """Monotonic total (counts, bytes). Cross-host merge: sum."""

    kind = "c"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _vector(self) -> List[float]:
        return [self._value]

    @staticmethod
    def _snapshot(vec) -> dict:
        return {"type": "counter", "value": float(vec[0])}


class Gauge:
    """Point-in-time level (mailbox depth, staleness). Cross-host
    merge: sum — a job-wide depth/budget is the sum of per-rank levels;
    per-rank values live in the local snapshot."""

    kind = "g"
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def _vector(self) -> List[float]:
        return [self._value]

    @staticmethod
    def _snapshot(vec) -> dict:
        return {"type": "gauge", "value": float(vec[0])}


class MaxGauge(Gauge):
    """Gauge whose cross-host merge takes the MAX instead of the sum —
    for levels where job-wide means worst-rank, not total (BSP
    staleness: two ranks each 3 stale is a skew of 3, not 6)."""

    kind = "m"
    __slots__ = ()

    @staticmethod
    def _snapshot(vec) -> dict:
        return {"type": "gauge", "value": float(vec[0])}


class Histogram:
    """Log-bucketed distribution (latencies, sizes): totals + fixed
    bucket vector, p50/p90/p99 estimated by in-bucket interpolation.
    Cross-host merge: elementwise sum of (count, sum, buckets)."""

    kind = "h"
    __slots__ = ("name", "_lock", "_count", "_sum", "_buckets")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._buckets = [0] * N_BUCKETS

    def observe(self, v: float) -> None:
        i = bucket_index(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._buckets[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _vector(self) -> List[float]:
        with self._lock:
            return [float(self._count), self._sum] + [
                float(b) for b in self._buckets]

    @staticmethod
    def percentile(buckets, count: float, q: float) -> float:
        """Estimate the q-quantile (0<q<1) from a bucket vector by
        linear interpolation inside the winning bucket."""
        if count <= 0:
            return 0.0
        target = q * count
        cum = 0.0
        for i, b in enumerate(buckets):
            if b <= 0:
                continue
            if cum + b >= target:
                lo, hi = bucket_bounds(i)
                frac = (target - cum) / b
                return lo + frac * (hi - lo)
            cum += b
        lo, hi = bucket_bounds(N_BUCKETS - 1)
        return hi

    @staticmethod
    def _snapshot(vec) -> dict:
        count = float(vec[0])
        total = float(vec[1])
        buckets = [float(b) for b in vec[2:2 + N_BUCKETS]]
        out = {
            "type": "histogram",
            "count": int(count),
            "sum": total,
            "mean": total / count if count else 0.0,
            "p50": Histogram.percentile(buckets, count, 0.50),
            "p90": Histogram.percentile(buckets, count, 0.90),
            "p99": Histogram.percentile(buckets, count, 0.99),
            # sparse bucket map (index -> count): full 64-wide vectors
            # would drown the snapshot; tests re-derive merges from this
            "buckets": {str(i): int(b) for i, b in enumerate(buckets)
                        if b > 0},
        }
        return out


class Digest:
    """Mergeable latency/size digest (round 22): a Histogram's bucket
    ladder plus exact min/max, built so two digests from DIFFERENT
    processes combine into the digest of the combined stream without
    any loss beyond the ladder itself.

    Vector layout (width ``N_BUCKETS + 4``): ``[count, sum, min, max,
    b0..b63]``. The merge is elementwise — count/sum/buckets add,
    min takes the min, max the max — which makes it exact (the merged
    vector equals the vector a single digest would have built from the
    concatenated stream), hence associative and commutative; the fleet
    accumulator relies on that to fold rollups in arrival order.

    Quantiles interpolate inside the winning ladder bucket (<= one
    octave of relative error, same bound as Histogram) and are then
    CLAMPED to the exact ``[min, max]`` — so single-sample and
    narrow-range digests report true values, not bucket upper bounds.
    Empty digests use ``+inf/-inf`` sentinels for min/max (the merge
    identity); they render as 0 in snapshots."""

    kind = "d"
    __slots__ = ("name", "_lock", "_count", "_sum", "_min", "_max",
                 "_buckets")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._buckets = [0] * N_BUCKETS

    def observe(self, v: float) -> None:
        v = float(v)
        i = bucket_index(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._buckets[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _vector(self) -> List[float]:
        with self._lock:
            return [float(self._count), self._sum, self._min,
                    self._max] + [float(b) for b in self._buckets]

    @staticmethod
    def empty_vector() -> List[float]:
        """The merge identity — what an untouched digest encodes to
        (and what absent ranks contribute in the cross-host merge)."""
        return [0.0, 0.0, math.inf, -math.inf] + [0.0] * N_BUCKETS

    @staticmethod
    def merge_vec(a, b) -> List[float]:
        """Exact elementwise merge of two digest vectors -> new list."""
        CHECK(len(a) == len(b) == N_BUCKETS + 4,
              f"digest vector width mismatch: {len(a)} vs {len(b)}")
        out = [float(a[0]) + float(b[0]), float(a[1]) + float(b[1]),
               min(float(a[2]), float(b[2])),
               max(float(a[3]), float(b[3]))]
        out.extend(float(a[i]) + float(b[i])
                   for i in range(4, N_BUCKETS + 4))
        return out

    def merge(self, other: "Digest") -> "Digest":
        """Pure combine: a NEW digest holding both streams."""
        merged = Digest(self.name)
        vec = Digest.merge_vec(self._vector(), other._vector())
        merged._count = int(vec[0])
        merged._sum = vec[1]
        merged._min = vec[2]
        merged._max = vec[3]
        merged._buckets = [int(b) for b in vec[4:]]
        return merged

    @staticmethod
    def quantile(vec, q: float) -> float:
        """Bounded-error q-quantile from a digest VECTOR: ladder
        interpolation clamped to the exact [min, max]."""
        count = float(vec[0])
        if count <= 0:
            return 0.0
        lo, hi = float(vec[2]), float(vec[3])
        est = Histogram.percentile(vec[4:4 + N_BUCKETS], count, q)
        return min(max(est, lo), hi)

    @staticmethod
    def _snapshot(vec) -> dict:
        count = float(vec[0])
        total = float(vec[1])
        return {
            "type": "digest",
            "count": int(count),
            "sum": total,
            "mean": total / count if count else 0.0,
            "min": float(vec[2]) if count else 0.0,
            "max": float(vec[3]) if count else 0.0,
            "p50": Digest.quantile(vec, 0.50),
            "p95": Digest.quantile(vec, 0.95),
            "p99": Digest.quantile(vec, 0.99),
            "buckets": {str(i): int(b)
                        for i, b in enumerate(vec[4:4 + N_BUCKETS])
                        if b > 0},
        }


_SNAPSHOTTERS = {"c": Counter._snapshot, "g": Gauge._snapshot,
                 "m": MaxGauge._snapshot, "h": Histogram._snapshot,
                 "d": Digest._snapshot}
_CLASSES = {"c": Counter, "g": Gauge, "m": MaxGauge, "h": Histogram,
            "d": Digest}


def _merge_cols(kind: str, cols):
    """Reduce a (ranks, width) column block to one merged vector per
    the kind's law: max-gauges take the rank max; digests merge
    columnwise (count/sum/buckets add, min-col min, max-col max);
    everything else sums elementwise."""
    if kind == "m":
        return cols.max(axis=0)
    if kind == "d":
        merged = cols.sum(axis=0)
        merged[2] = cols[:, 2].min()
        merged[3] = cols[:, 3].max()
        return merged
    return cols.sum(axis=0)


class MetricsRegistry:
    """Process-wide named instrument registry (lazy get-or-create, the
    Dashboard.Get idiom, typed)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        if not enabled():
            return NULL
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name)
                self._instruments[name] = inst
        CHECK(isinstance(inst, cls),
              f"telemetry instrument {name!r} already registered as "
              f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def max_gauge(self, name: str) -> MaxGauge:
        return self._get(name, MaxGauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def digest(self, name: str) -> Digest:
        return self._get(name, Digest)

    def digest_vectors(self) -> Dict[str, List[float]]:
        """{name: vector} of every registered Digest: the fleet rollup's
        raw material. Never collective."""
        with self._lock:
            items = [(n, i) for n, i in self._instruments.items()
                     if i.kind == "d"]
        return {name: inst._vector() for name, inst in sorted(items)}

    def gauge_values(self, prefixes=()) -> Dict[str, float]:
        """{name: value} of the gauges and max-gauges, optionally only
        those under a name prefix: the fleet rollup's key gauges. Never
        collective."""
        pfx = tuple(prefixes)
        with self._lock:
            return {n: float(i.value)
                    for n, i in self._instruments.items()
                    if i.kind in ("g", "m")
                    and (not pfx or n.startswith(pfx))}

    def snapshot(self) -> Dict[str, dict]:
        """LOCAL snapshot: {name: typed dict}. Never collective — safe
        from any thread (the periodic reporter calls it on a timer)."""
        with self._lock:
            items = list(self._instruments.items())
        return {name: _SNAPSHOTTERS[inst.kind](inst._vector())
                for name, inst in sorted(items)}

    def merged_snapshot(self) -> Dict[str, dict]:
        """Job-wide snapshot summed over every host. COLLECTIVE in a
        multi-process world (every rank must call it at the same point,
        with the engine quiesced — like MV_Barrier); identity locally.
        The exchanges ride the gloo control group
        (``multihost.host_allgather_bytes``), never an engine wire
        channel.

        Union-of-names: ranks may hold disjoint instrument sets
        (role-specific counters), so ``kind:name`` tags are exchanged
        first and one data exchange carries fixed-width vectors laid
        out from the sorted union — every rank agrees on shape. The
        reduce runs client-side per kind: counters/gauges/histograms
        sum elementwise, max-gauges take the rank maximum."""
        import numpy as np

        from multiverso_tpu_torch.parallel import multihost

        with self._lock:
            local = {name: (inst.kind, inst._vector())
                     for name, inst in self._instruments.items()}
        tagged = {f"{kind}:{name}" for name, (kind, _) in local.items()}
        if multihost.world_size() > 1:
            blobs = multihost.host_allgather_bytes(
                "\x00".join(sorted(tagged)).encode())
            union = set()
            for blob in blobs:
                if blob:
                    union.update(blob.decode().split("\x00"))
        else:
            union = tagged
        tags = sorted(union)
        kinds = {}
        for tag in tags:
            kind, _, name = tag.partition(":")
            CHECK(name not in kinds,
                  f"telemetry instrument {name!r} has divergent kinds "
                  f"across hosts — every rank must register a name with "
                  f"one type")
            kinds[name] = kind
        names = sorted(kinds)
        if not names:
            return {}
        vec: List[float] = []
        for name in names:
            kind = kinds[name]
            have = local.get(name)
            if have is not None and have[0] == kind:
                vec.extend(have[1])
            elif kind == "d":
                # digest identity is NOT all-zeros: min/max sentinels
                vec.extend(Digest.empty_vector())
            else:
                vec.extend([0.0] * _WIDTHS[kind])
        arr = np.asarray(vec, np.float64)
        if multihost.world_size() > 1:
            # allgather (not allreduce-sum) so each kind picks its own
            # reduction: max-gauges must not sum across ranks
            blobs = multihost.host_allgather_bytes(arr.tobytes())
            ranks = np.stack([np.frombuffer(b, np.float64)
                              for b in blobs])
        else:
            ranks = arr.reshape(1, -1)
        out: Dict[str, dict] = {}
        pos = 0
        for name in names:
            kind = kinds[name]
            width = _WIDTHS[kind]
            cols = ranks[:, pos:pos + width]
            out[name] = _SNAPSHOTTERS[kind](_merge_cols(kind, cols))
            pos += width
        return out

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._instruments.clear()


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def max_gauge(name: str) -> MaxGauge:
    return REGISTRY.max_gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def digest(name: str) -> Digest:
    return REGISTRY.digest(name)


def snapshot() -> Dict[str, dict]:
    return REGISTRY.snapshot()


def merged_snapshot() -> Dict[str, dict]:
    return REGISTRY.merged_snapshot()


def _reset_for_tests() -> None:
    REGISTRY._reset_for_tests()
