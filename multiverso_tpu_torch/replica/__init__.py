"""Replica plane: delta-snapshot fan-out and an out-of-process read tier.

The port's own copy of ``multiverso_tpu/replica/``. The serving plane
splits reads from the verb stream but serves them from the TRAINING
process, where every reader shares its cores and interpreter lock. This
package is the parameter server's read/update split taken to separate
processes:

* :mod:`delta` — the versioned delta codec: per-table "rows dirtied since
  version V" blobs (a row bitmap for matrix/sparse tables, a write-set of
  keys for kv tables, a whole-table flag for arrays), a full-base blob for
  a first join, all sealed with the CRC trailer of ``parallel/seal.py``,
  and the reader-side mirror store that applies them. A bundle holds only
  numpy arrays, ints, floats, strings and dicts, so the JAX package's
  reader decodes the port's blobs and the other way round.
* :mod:`publisher` — the trainer side: ``MV_PublishSnapshot``'s capture
  drains each table's journal at the fenced cut, and a fan-out thread
  ships base and delta blobs to subscribed readers: same-host readers over
  a dedicated shm ring a reader, cross-host readers over a dedicated tcp
  stream (the reader binds its listener before joining; the publisher
  dials it at the first ship), relay readers through the coordinator's
  mailbox.
* :mod:`replica` — the reader process: joins through the coordinator as
  a ``role=replica`` member with a heartbeat lease but no verb stream,
  keeps local version mirrors under ``SnapshotStore``'s retention and pin
  contract and serves lookups through a reused ``ServingFrontend`` on host
  snapshots. It loads torch with the package but never makes a CUDA
  context (its status file says so): readers beside a trainer add no
  context to the card.

The flags live HERE so the Zoo's import registers them before MV_Init's
``ParseCMDFlags``.
"""

from __future__ import annotations

from typing import List, Optional

from multiverso_tpu_torch.utils.configure import (MV_DEFINE_bool,
                                                  MV_DEFINE_double,
                                                  MV_DEFINE_int,
                                                  MV_DEFINE_string)

MV_DEFINE_bool("mv_replica_fanout", False,
               "replica plane: journal per-table publish dirty sets and "
               "fan published snapshots out to subscribed replica "
               "reader processes as versioned base+delta blobs "
               "(same-host: shm ring; cross-host: tcp wire stream; "
               "relay: coordinator mailbox)")
MV_DEFINE_string("mv_replica_addr", "",
                 "replica subscription coordinator endpoint host:port. "
                 "Empty: reuse the elastic coordinator when -mv_elastic "
                 "is up, else rank 0 hosts one on loopback with an "
                 "ephemeral port (single-process worlds; multi-process "
                 "worlds without -mv_elastic must name a port)")
MV_DEFINE_int("mv_replica_ring_bytes", 8 << 20,
              "per-subscriber fan-out capacity: shm ring bytes "
              "(same-host) or tcp chunk cap (cross-host); frames "
              "larger than this ship as multiple flow-controlled "
              "chunks")
MV_DEFINE_double("mv_replica_lease_s", 0.0,
                 "replica heartbeat lease: a replica silent for this "
                 "long is declared dead and its subscription evicted "
                 "at the next fan-out tick (0 = derive from "
                 "-mv_deadline_s like the elastic lease, floor 2s, "
                 "default 5s)")

from multiverso_tpu_torch.replica import delta  # noqa: E402,F401


def start_plane(zoo) -> bool:
    """Bring the publisher up when ``-mv_replica_fanout`` is set
    (Zoo.Start). Returns True when active on this rank."""
    from multiverso_tpu_torch.replica import publisher
    return publisher.start_plane(zoo)


def shutdown_plane() -> None:
    """Stop the fan-out thread and drop every subscription wire
    (Zoo.Stop)."""
    from multiverso_tpu_torch.replica import publisher
    publisher.shutdown_plane()


def note_publish(engine, snap) -> None:
    """Publish-cut hook (serving/snapshot._capture_all, ON the engine
    thread with every stream fenced): drain the per-table journals into
    the dirty-set record for ``snap.version`` and kick the fan-out
    thread. One attribute read when the plane is off."""
    from multiverso_tpu_torch.replica import publisher
    publisher.note_publish(engine, snap)


def maybe_attach_journal(server_table) -> None:
    """RegisterTable hook (sync/server.py): attach the publish dirty
    journal when this rank fans out. No-op when the plane is off."""
    from multiverso_tpu_torch.replica import publisher
    publisher.maybe_attach_journal(server_table)


def status_report() -> Optional[dict]:
    """Local publisher view for /healthz (a line a replica), never
    collective, served from the fan-out thread's cached roster."""
    from multiverso_tpu_torch.replica import publisher
    return publisher.status_report()


def peek_sample() -> Optional[dict]:
    """Watchdog probe: {replica_subscribers, replica_lag_versions} from
    local publisher state, or None when the plane is off."""
    from multiverso_tpu_torch.replica import publisher
    return publisher.peek_sample()


def ledger_bytes() -> Optional[dict]:
    """Accounting-ledger probe: journal + retained dirty-set bytes on
    the fan-out rank (None when the plane is off)."""
    from multiverso_tpu_torch.replica import publisher
    return publisher.ledger_bytes()


def status_lines() -> List[str]:
    """Dashboard line for DisplayAll — [] when the plane never ran."""
    rep = status_report()
    if rep is None:
        return []
    subs = rep.get("subscribers", [])
    live = [s for s in subs if s.get("state") == "live"]
    return ["[Replica] subscribers = %d live / %d known, latest = v%s, "
            "max_lag = %s, fanout = %d bytes" % (
                len(live), len(subs), rep.get("latest"),
                rep.get("max_lag"), rep.get("fanout_bytes", 0))]
