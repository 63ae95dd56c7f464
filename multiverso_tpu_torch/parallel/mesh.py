"""Device context and the partition math.

Counterpart of ``multiverso_tpu/parallel/mesh.py``. The JAX package hosts
table shards on a ``jax.sharding.Mesh`` whose ``server`` axis is the server
fabric; this slice of the port runs one server shard on one
``torch.device``, so ``MeshContext`` becomes a ``DeviceContext`` with
``num_servers == 1`` and explicit ``place``/``fetch``. The partition math
is copied unchanged so that both packages agree on row ownership.

Device rule: a world runs on ``cuda:0`` unless the caller asks for the CPU,
through ``-mv_device=cpu`` or ``MV_Init(argv, devices=[torch.device("cpu")])``.
In a multi-process world rank r runs on ``cuda:(r % device_count)`` unless
``-mv_device`` names a card.
With neither and no CUDA device present, creating the context raises: the
port never carries on silently on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.utils.configure import GetFlag, MV_DEFINE_string
from multiverso_tpu_torch.utils.log import CHECK

MV_DEFINE_string("mv_device", "cuda",
                 "torch device the world's tables live on: cuda, cuda:N or "
                 "cpu (cpu must be asked for; cuda without a card raises)")


def partition_offsets(size: int, num_servers: int) -> List[Tuple[int, int]]:
    """[(offset, count)] per server; the last server takes the remainder
    (reference array_table.cpp:101-105)."""
    if num_servers <= 0:
        raise ValueError("num_servers must be positive")
    base = size // num_servers
    out = []
    for s in range(num_servers):
        count = base if s < num_servers - 1 else size - base * (num_servers - 1)
        out.append((base * s, count))
    return out


def ceil_block_rows(num_rows: int, num_servers: int) -> int:
    """Rows per server shard in the interleaved storage layout."""
    return -(-num_rows // num_servers)


def storage_partition_server(row: int, num_rows: int, num_servers: int) -> int:
    """Which server shard owns a row: ceil-based equal blocks."""
    block = ceil_block_rows(num_rows, num_servers)
    return min(row // block, num_servers - 1)


def next_bucket(n: int, min_bucket: int = 8) -> int:
    """Smallest bucket size >= n (and >= min_bucket): powers of two up to
    256, then quarter-octave steps. The port pads nothing to buckets for a
    compiler's sake (PyTorch runs eagerly); WordEmbedding's block builder
    still rounds its batch count with it, so both packages cut a block
    into the same batches, and the compressed row wire pads its payload
    to it, so both packages send the same bytes."""
    b = min_bucket
    while b < n:
        b <<= 1
    if b <= 256:
        return b
    half = b >> 1
    for num in (5, 6, 7):
        cand = (half * num) // 4
        if cand >= n:
            return cand
    return b


def resolve_device(devices: Optional[Sequence] = None) -> torch.device:
    """The world's device under the device rule (module docstring)."""
    if devices:
        CHECK(len(devices) == 1,
              f"this port runs one server shard on one device; got "
              f"{len(devices)} devices")
        dev = torch.device(devices[0])
    else:
        dev = torch.device(str(GetFlag("mv_device")))
    if dev.type == "cuda":
        CHECK(torch.cuda.is_available(),
              "MV_Init: no CUDA device is available. The port runs on the "
              "GPU unless the CPU is asked for: pass -mv_device=cpu or "
              "devices=[torch.device('cpu')]")
        if dev.index is None:
            # one card per rank when there are enough, else ranks share
            # (two gloo ranks on one card are fine; NCCL would refuse)
            from multiverso_tpu_torch.parallel import multihost
            dev = torch.device("cuda", multihost.world_rank()
                               % torch.cuda.device_count())
    else:
        CHECK(dev.type == "cpu", f"unsupported device {dev}")
    return dev


@dataclass
class DeviceContext:
    """Owns the world's device: one server shard, explicit host<->device
    placement."""

    device: torch.device

    @classmethod
    def create(cls, devices: Optional[Sequence] = None) -> "DeviceContext":
        return cls(device=resolve_device(devices))

    @property
    def num_servers(self) -> int:
        return 1

    def place(self, array) -> torch.Tensor:
        """Host numpy -> a tensor on the world's device."""
        return torch.as_tensor(array).to(self.device)

    def fetch(self, t) -> np.ndarray:
        """Device -> host numpy. ``.cpu()`` waits for the device, so the
        result is complete when this returns; a CPU tensor is copied so
        the caller never aliases live storage."""
        if isinstance(t, torch.Tensor):
            host = t.detach().cpu()
            if host.data_ptr() == t.data_ptr():
                host = host.clone()
            return host.numpy()
        return np.array(t)
