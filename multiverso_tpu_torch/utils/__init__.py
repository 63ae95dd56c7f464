"""Runtime utilities: flags, logging, queues, waiters, timers, streams."""

from multiverso_tpu_torch.utils.configure import (  # noqa: F401
    MV_DEFINE_bool,
    MV_DEFINE_double,
    MV_DEFINE_int,
    MV_DEFINE_string,
    GetFlag,
    SetCMDFlag,
    ParseCMDFlags,
)
from multiverso_tpu_torch.utils.log import (  # noqa: F401
    Log, Logger, LogLevel, CHECK, CHECK_NOTNULL)
from multiverso_tpu_torch.utils.timer import Timer  # noqa: F401
from multiverso_tpu_torch.utils.dashboard import (  # noqa: F401
    Dashboard, Monitor, monitor_region)
from multiverso_tpu_torch.utils.waiter import Waiter  # noqa: F401
from multiverso_tpu_torch.utils.mt_queue import MtQueue  # noqa: F401
from multiverso_tpu_torch.utils.async_buffer import ASyncBuffer  # noqa: F401
