"""Consistency modes: the server engines (reference L4)."""

from multiverso_tpu_torch.sync.server import Server  # noqa: F401
