"""Client-side delta transforms (the port's copy of
``multiverso_tpu/models/logreg/updater.py``; reference
Applications/LogisticRegression/src/updater/): the trained gradient is
turned into the pushed delta here; the server (or local table) then does
``data -= delta``.

* default: identity (reference updater.cpp:11-37 base Update just subtracts)
* sgd: scale by a decaying learning rate
  ``lr = max(1e-3, lr0 - update_count / (learning_rate_coef * minibatch))``
  (reference updater.cpp:52-71)
* ftrl: handled structurally by the FTRL state tables (updater.cpp:78-102) —
  the client pushes (delta_z, delta_n) directly, so Process is identity.
"""

from __future__ import annotations


class ClientUpdater:
    name = "default"

    def __init__(self, config):
        self._config = config

    def learning_rate(self) -> float:
        """Scale applied to the averaged gradient before pushing."""
        return 1.0

    def tick(self) -> None:
        """One minibatch processed."""


class ClientSGDUpdater(ClientUpdater):
    name = "sgd"

    def __init__(self, config):
        super().__init__(config)
        self._initial = config.learning_rate
        self._coef = config.learning_rate_coef
        self._minibatch = config.minibatch_size
        self._count = 0
        self._lr = self._initial

    def learning_rate(self) -> float:
        return self._lr

    def tick(self) -> None:
        self._count += 1
        self._lr = max(1e-3, self._initial -
                       self._count / (self._coef * self._minibatch))


def create_client_updater(config) -> ClientUpdater:
    """reference updater.cpp:105-117 factory."""
    if config.objective_type == "ftrl" or config.updater_type == "ftrl":
        return ClientUpdater(config)  # identity; FTRL math lives in the step
    if config.updater_type == "sgd":
        return ClientSGDUpdater(config)
    return ClientUpdater(config)
