"""SnapshotStore: retention, pinning and read-your-version semantics (the
port's counterpart of ``multiverso_tpu/serving/store.py``).

The store owns every published :class:`~multiverso_tpu_torch.serving.
snapshot.Snapshot` of this process. Versions are small increasing ints
allocated at publish time ON the engine thread. In a multi-process world
every rank publishes at the same stream position, so the per-rank counters
march in lockstep and "version 3" names the same cut on every rank without
any agreement collective.

Contracts:

* **read-your-version**: ``get(v)`` returns exactly the snapshot published
  as ``v`` while ``v`` is live (retained or pinned); a snapshot is
  immutable after install, so two lookups of one version cannot differ
  however far training advances.
* **retention**: the newest ``-mv_serving_keep`` versions stay live; older
  UNPINNED versions are evicted at the next install, and the store drops
  its last reference to their buffers (a device copy goes back to the
  CUDA caching allocator once no caller holds it). A pin
  (``MV_PinVersion``) holds a version past retention until the matching
  unpin; pins nest.
* **monotonic latest**: ``get(None)`` serves the newest installed version.

Telemetry as in the JAX store: the ``serving.publishes`` and
``serving.evictions`` counters, the ``serving.live_versions`` gauge and the
``snapshot.publish``/``snapshot.evict`` flight events.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.configure import GetFlag
from multiverso_tpu_torch.utils.log import CHECK, Log


def _keep() -> int:
    """``-mv_serving_keep`` (defined in serving/__init__.py), at least 1."""
    return max(1, int(GetFlag("mv_serving_keep")))


class SnapshotStore:
    def __init__(self):
        self._lock = threading.Lock()
        #: version -> Snapshot, in version order
        self._versions: "collections.OrderedDict" = collections.OrderedDict()
        self._pins: Dict[int, int] = {}
        self._next_version = 1
        self._t_live = tmetrics.gauge("serving.live_versions")
        self._t_published = tmetrics.counter("serving.publishes")
        self._t_evicted = tmetrics.counter("serving.evictions")

    # -- publish side (engine thread) ----------------------------------------

    def alloc_version(self) -> int:
        """The next version number. Called only from the publish cut (the
        engine thread, a lockstep stream position), so the sequence
        1, 2, 3, ... is the same on every rank."""
        with self._lock:
            v = self._next_version
            self._next_version += 1
            return v

    def install(self, snap) -> None:
        """File one published snapshot, then evict every unpinned version
        older than the newest ``-mv_serving_keep``."""
        keep = _keep()
        with self._lock:
            CHECK(snap.version not in self._versions,
                  f"snapshot version {snap.version} published twice")
            self._versions[snap.version] = snap
            for v in list(self._versions)[:-keep]:
                if self._pins.get(v, 0) == 0:
                    del self._versions[v]
                    self._t_evicted.inc()
                    tflight.record("snapshot.evict", detail=f"v{v}")
            self._t_published.inc()
            self._t_live.set(len(self._versions))
        tflight.record("snapshot.publish",
                       epoch=getattr(snap, "window_epoch", -1),
                       detail=f"v{snap.version}")

    # -- read side (any thread) ----------------------------------------------

    def get(self, version: Optional[int] = None):
        """The snapshot of ``version`` (None = the latest). Raises KeyError
        when nothing is published yet or the version was evicted."""
        with self._lock:
            if not self._versions:
                raise KeyError(
                    "no snapshot published yet: call MV_PublishSnapshot() "
                    "before serving lookups")
            if version is None:
                return next(reversed(self._versions.values()))
            snap = self._versions.get(version)
            if snap is None:
                raise KeyError(
                    f"snapshot version {version} is not live (evicted by "
                    f"retention, or never published); live: "
                    f"{list(self._versions)}; pin the versions you serve "
                    f"from (MV_PinVersion) to hold them past "
                    f"-mv_serving_keep")
            return snap

    def latest_version(self) -> Optional[int]:
        with self._lock:
            return next(reversed(self._versions)) if self._versions else None

    def live_versions(self) -> List[int]:
        with self._lock:
            return list(self._versions)

    def pin(self, version: int) -> int:
        """Hold ``version`` live past retention (pins nest); returns it.
        KeyError when it is not live any more."""
        with self._lock:
            if version not in self._versions:
                raise KeyError(
                    f"cannot pin snapshot version {version}: not live "
                    f"(live: {list(self._versions)})")
            self._pins[version] = self._pins.get(version, 0) + 1
            return version

    def unpin(self, version: int) -> None:
        """Release one pin; a version left without pins and older than the
        retention window is evicted at once."""
        keep = _keep()
        with self._lock:
            n = self._pins.get(version, 0)
            if n <= 0:
                Log.Error("unpin of snapshot version %d without a pin: "
                          "no-op", version)
                return
            if n == 1:
                del self._pins[version]
                if version in list(self._versions)[:-keep]:
                    del self._versions[version]
                    self._t_evicted.inc()
                    tflight.record("snapshot.evict", detail=f"v{version}")
                    self._t_live.set(len(self._versions))
            else:
                self._pins[version] = n - 1
