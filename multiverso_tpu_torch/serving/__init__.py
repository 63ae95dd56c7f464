"""Serving plane: immutable versioned snapshots and a batched read path
(the port's counterpart of ``multiverso_tpu/serving/``).

The training plane routes every read through the engine's verb stream,
where it contends with training windows. This package adds the parameter
server's read tier: ``publish`` cuts an immutable, versioned,
cross-table-consistent snapshot inside the engine stream (snapshot.py), a
``SnapshotStore`` retains and pins versions (store.py), and a
``ServingFrontend`` answers concurrent batched lookups from snapshots
without touching the verb stream (frontend.py): deadline-bounded,
load-shedding, one union read per table per batch.

Public surface: ``MV_PublishSnapshot`` / ``MV_ServingLookup`` /
``MV_PinVersion`` / ``MV_UnpinVersion`` (api.py).

The flags live here, so zoo's eager import registers them before
``MV_Init``'s ``ParseCMDFlags``. ``status_lines`` is the Dashboard's
``[Serving]`` line (``utils/dashboard.py`` DisplayAll).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from multiverso_tpu_torch.utils.configure import (MV_DEFINE_double,
                                                  MV_DEFINE_int,
                                                  MV_DEFINE_string)

MV_DEFINE_int("mv_serving_keep", 2,
              "snapshot retention: the newest N published versions stay "
              "live; older unpinned versions are evicted at the next "
              "publish (MV_PinVersion holds one past retention)")
MV_DEFINE_int("mv_serving_max_inflight", 4096,
              "serving admission bound: a lookup arriving while this many "
              "are queued is shed with a typed ServingOverloaded")
MV_DEFINE_double("mv_serving_batch_window_s", 0.0,
                 "serving coalesce window: the dispatcher waits this long "
                 "after the first queued lookup so concurrent callers "
                 "share one read (0 = serve what has queued by dispatch "
                 "time)")
MV_DEFINE_string("mv_serving_residence", "auto",
                 "snapshot residence: host (copy-on-publish numpy), device "
                 "(one on-device copy of a matrix table's storage read by "
                 "the row gather; one process, no updater aux state), auto "
                 "(device for a table on a CUDA device where legal, else "
                 "host)")

from multiverso_tpu_torch.serving.frontend import (  # noqa: E402,F401
    LookupTicket, ServingFrontend)
from multiverso_tpu_torch.serving.snapshot import publish  # noqa: E402,F401
from multiverso_tpu_torch.serving.store import SnapshotStore  # noqa: E402


class ServingPlane:
    """Per-process serving state: one store and one front-end."""

    def __init__(self):
        self.store = SnapshotStore()
        self.frontend = ServingFrontend(self.store)


_lock = threading.Lock()
_plane: Optional[ServingPlane] = None


def get_plane() -> ServingPlane:
    """The process's serving plane (created on first use)."""
    global _plane
    with _lock:
        if _plane is None:
            _plane = ServingPlane()
        return _plane


def peek_plane() -> Optional[ServingPlane]:
    """The plane if one exists; never creates one."""
    return _plane


def shutdown_plane() -> None:
    """Stop the front-end's dispatcher and drop every snapshot (Zoo.Stop:
    a later MV_Init world starts from a fresh plane)."""
    global _plane
    with _lock:
        plane, _plane = _plane, None
    if plane is not None:
        plane.frontend.stop()


def status_lines() -> List[str]:
    """Dashboard lines for DisplayAll: [] when serving never ran."""
    plane = peek_plane()
    if plane is None:
        return []
    from multiverso_tpu_torch.telemetry import metrics
    snap = metrics.snapshot()

    def val(name, key="value", default=0):
        return snap.get(name, {}).get(key, default)

    latest = plane.store.latest_version()
    age = epoch = 0.0
    if latest is not None:
        snap_latest = plane.store.get(None)
        age = snap_latest.age_s()
        epoch = snap_latest.window_epoch   # the cut's stream position
    return [
        "[Serving] lookups = %d, shed = %d, p99 = %.3f ms, "
        "batch_p50 = %.1f, snapshot_age = %.1f s, live_versions = %s "
        "(latest v%s @ window epoch %s)" % (
            val("serving.lookups"),
            val("serving.shed"),
            1e3 * val("serving.latency_s", "p99", 0.0),
            val("serving.batch_size", "p50", 0.0),
            age,
            plane.store.live_versions(),
            latest,
            epoch,
        )
    ]
