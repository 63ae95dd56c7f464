"""Shared MV-world ownership guard for application drivers (the port's
own copy of ``multiverso_tpu/utils/world.py``).

A driver that lazily ``MV_Init``'s a world owes the process the reverse
obligation: if anything raises while the driver owns a started Zoo, the
Zoo comes down with the exception, because a stranded world poisons every
later ``MV_Init`` in the process.
"""

from __future__ import annotations

import contextlib

from multiverso_tpu_torch.utils.log import Log


class WorldOwner:
    """``init_if_needed(argv)`` starts a world only when none is up;
    ``guard()`` closes an owned world when its block raises; ``close()``
    is idempotent."""

    def __init__(self) -> None:
        self.owns = False

    def init_if_needed(self, argv=()) -> None:
        from multiverso_tpu_torch import api
        from multiverso_tpu_torch.zoo import Zoo
        if not Zoo.Get().started:
            api.MV_Init(list(argv))
            self.owns = True

    def close(self) -> None:
        if self.owns:
            from multiverso_tpu_torch import api
            self.owns = False
            api.MV_ShutDown()

    @contextlib.contextmanager
    def guard(self, context: str):
        try:
            yield
        except BaseException:
            try:
                self.close()
            except Exception as exc:
                Log.Error("[%s] world shutdown after failure itself failed "
                          "(%r); original error follows", context, exc)
            raise
