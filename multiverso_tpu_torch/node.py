"""Node/Role records (the port's own copy of ``multiverso_tpu/node.py``,
reference node.h:6-20): a node is a (rank, role bitmask, worker_id,
server_id) record; ``ps_role=default`` maps to ALL.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Role(enum.IntFlag):
    NONE = 0
    WORKER = 1
    SERVER = 2
    ALL = 3


ROLE_NAMES = {
    "none": Role.NONE,
    "worker": Role.WORKER,
    "server": Role.SERVER,
    "default": Role.ALL,
    "all": Role.ALL,
}


@dataclass
class Node:
    rank: int = 0
    role: Role = Role.ALL
    worker_id: int = -1
    server_id: int = -1

    def is_worker(self) -> bool:
        return bool(self.role & Role.WORKER)

    def is_server(self) -> bool:
        return bool(self.role & Role.SERVER)
