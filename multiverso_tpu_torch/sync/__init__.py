"""Consistency modes: the server engines (reference L4)."""

from multiverso_tpu_torch.sync.server import (  # noqa: F401
    Server, SyncServer, VectorClock)
