"""Runtime utilities: flags, logging, queues, waiters, timers, streams."""

from multiverso_tpu_torch.utils.async_buffer import ASyncBuffer  # noqa: F401
