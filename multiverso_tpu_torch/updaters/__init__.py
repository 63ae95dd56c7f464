"""Server-side updaters (reference include/multiverso/updater/)."""

from multiverso_tpu_torch.updaters.base import (  # noqa: F401
    AdaGradUpdater,
    AddOption,
    AddUpdater,
    CreateUpdater,
    DCASGDUpdater,
    GetOption,
    MomentumUpdater,
    SGDUpdater,
    Updater,
)
