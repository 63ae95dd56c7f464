"""Runtime utilities: flags, logging, queues, waiters, timers, streams."""
