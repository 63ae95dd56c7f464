"""Bounded frequency sketches for access-skew measurement.

The ROADMAP's giant-table hot-row cache needs its measurement first:
WHICH rows of a MatrixTable do Gets actually hit, and how skewed is
the distribution? A per-row counter array would cost O(num_rows);
this module provides the bounded classic instead — the Space-Saving
top-K sketch (Metwally et al., "Efficient computation of frequent and
top-k elements in data streams"): at most ``capacity`` tracked keys,
each with a count and an over-count bound (the count a key may have
inherited when it evicted the minimum). Guarantees: every true heavy
hitter with frequency > N/capacity IS tracked, and a tracked count
over-estimates the truth by at most its recorded error bound.

Off by default behind ``-mv_row_sketch`` (the capacity; 0 disables —
tables never construct a sketch, the per-Get cost is one cached int
read). Updates run on the engine actor thread; reads (dashboard,
/metrics gauge, /perf) take the same short lock.
"""

from __future__ import annotations

import heapq
import threading
from typing import List, Tuple

from multiverso_tpu_torch.utils.configure import MV_DEFINE_int, cached_int_flag

MV_DEFINE_int("mv_row_sketch", 0,
              "per-row access-skew sketch on MatrixTable row Gets AND "
              "KVTable key Gets (round 13): track the top-N hottest "
              "rows/keys per table in a bounded Space-Saving sketch "
              "(0 = off, no per-Get cost beyond one cached flag "
              "read). Surfaced in /metrics "
              "(table.<family><id>.row_skew_top_share), the Dashboard "
              "[RowSkew] line and /perf — the measurement groundwork "
              "for the ROADMAP's hot-row cache, which needs skew on "
              "both families.")

#: the -mv_row_sketch gate, listener-cached (consulted per Get)
row_sketch_capacity = cached_int_flag("mv_row_sketch", 0)

#: how many top rows the share gauge/summary aggregates over
TOP_N = 8


class SpaceSaving:
    """Space-Saving top-K: bounded dict of key -> (count, err).

    Eviction finds the minimum through a LAZY-DELETION HEAP instead of
    an O(capacity) scan: entries are (count, key) pushed at insert
    time; a popped entry whose count no longer matches the live dict
    is stale (the key was incremented or already evicted) and is
    discarded. When the heap runs dry of valid entries it is rebuilt
    from the live counts — amortized O(log capacity) per eviction, so
    an armed sketch on a low-skew stream (nearly every id evicting)
    stays cheap on the engine actor thread instead of becoming the
    apply-stage stall it is meant to measure."""

    def __init__(self, capacity: int):
        self.capacity = max(2, int(capacity))
        self._lock = threading.Lock()
        self._counts: dict = {}
        self._errs: dict = {}
        self._heap: list = []       # lazy (count, key) min-candidates
        self._total = 0

    def update(self, key, n: int = 1) -> None:
        with self._lock:
            self._update_locked(key, n)

    def _evict_min_locked(self):
        """Pop the true minimum's (key, count), lazy-heap style."""
        counts = self._counts
        while self._heap:
            c, key = heapq.heappop(self._heap)
            if counts.get(key) == c:
                return key, c
        # every candidate went stale (hot keys grew past their pushed
        # counts): rebuild from the live dict — rare, O(capacity)
        self._heap = [(c, k) for k, c in counts.items()]
        heapq.heapify(self._heap)
        c, key = heapq.heappop(self._heap)
        return key, c

    def _update_locked(self, key, n: int) -> None:
        self._total += n
        counts = self._counts
        if key in counts:
            # no heap push: the key's old (smaller) entry goes stale
            # and is discarded by the validity check at eviction time
            counts[key] += n
            return
        if len(counts) < self.capacity:
            counts[key] = n
            self._errs[key] = 0
            heapq.heappush(self._heap, (n, key))
            return
        # evict the minimum; the newcomer inherits its count as the
        # over-estimate bound (the Space-Saving replacement rule)
        victim, floor = self._evict_min_locked()
        counts.pop(victim, None)
        self._errs.pop(victim, None)
        counts[key] = floor + n
        self._errs[key] = floor
        heapq.heappush(self._heap, (floor + n, key))
        if len(self._heap) > 8 * self.capacity:
            # stale-entry bound: churn-heavy streams rebuild instead
            # of letting discarded candidates accumulate
            self._heap = [(c, k) for k, c in counts.items()]
            heapq.heapify(self._heap)

    def update_ids(self, ids) -> None:
        """Count one Get's row-id array. Deduplicated first: per-Get
        cost is O(unique ids) dict ops under one short lock."""
        import numpy as np
        uniq, cnt = np.unique(np.asarray(ids).ravel(),
                              return_counts=True)
        with self._lock:
            for key, n in zip(uniq.tolist(), cnt.tolist()):
                self._update_locked(key, int(n))

    @property
    def total(self) -> int:
        return self._total

    def top(self, n: int = TOP_N) -> List[Tuple[int, int, int]]:
        """The ``n`` hottest tracked keys as (key, count,
        overcount_bound), hottest first."""
        with self._lock:
            items = sorted(self._counts.items(), key=lambda kv: -kv[1])
            return [(k, c, self._errs.get(k, 0)) for k, c in items[:n]]

    def top_share(self, n: int = TOP_N) -> float:
        """Fraction of ALL counted accesses landing on the current
        top-``n`` keys (0.0 when nothing counted) — the one-number
        skew signal the /metrics gauge carries. An over-estimate by at
        most the tracked error bounds, like every Space-Saving read."""
        with self._lock:
            if self._total <= 0:
                return 0.0
            counts = sorted(self._counts.values(), reverse=True)
            return min(1.0, sum(counts[:n]) / self._total)

    def summary(self, n: int = TOP_N) -> dict:
        """JSON-ready summary for /perf and the dashboard line."""
        return {"total": self.total, "capacity": self.capacity,
                "top_share": round(self.top_share(n), 4),
                "top": [{"key": int(k), "count": int(c),
                         "overcount_max": int(e)}
                        for k, c, e in self.top(n)]}


def note_table_access(table, ids, fam: str) -> None:
    """The ONE per-Get sketch hook both table families ride (round 13
    extended the matrix-only round-11 hook to KVTable key Gets): feed
    one Get's id/key array to ``table._row_sketch``, creating it
    lazily when ``-mv_row_sketch`` arms. The off path is one cached
    int read; the /metrics top-share gauge refreshes every 32 notes,
    not per Get. ``table`` must carry ``_row_sketch`` /
    ``_row_sketch_notes`` slots (both families initialize them)."""
    cap = row_sketch_capacity()
    if cap <= 0:
        return
    sk = table._row_sketch
    if sk is None:
        sk = table._row_sketch = SpaceSaving(cap)
    sk.update_ids(ids)
    table._row_sketch_notes += 1
    if table._row_sketch_notes & 31 == 1:
        from multiverso_tpu_torch.telemetry import metrics as tmetrics
        tmetrics.gauge(
            f"table.{fam}{getattr(table, 'table_id', 0)}"
            f".row_skew_top_share").set(sk.top_share())
