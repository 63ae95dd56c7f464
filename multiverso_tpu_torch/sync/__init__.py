"""Consistency modes: the async server engine (reference L4)."""

from multiverso_tpu_torch.sync.server import Server  # noqa: F401
