"""Plain reference of the parameter server's matrix table under the
default ``add`` updater: a (rows, cols) table, zero at the start, each
AddRows adds its deltas to its rows, GetRows reads the rows, Get reads the
table.

Plain PyTorch (numpy inputs); imports nothing of the program. Every
worker writes only its own rows, so each worker's rounds replay in its
own order and every Get of a worker's rows has one right answer: the sum
of that worker's deltas so far.
"""

from __future__ import annotations

import numpy as np
import torch

#: the verbs a round may hold
VERBS = ("AddRows", "GetRows", "Get")


def replay(rows: int, cols: int, pools: list, rounds: list, kept: list,
           verbs: list, own: list, device) -> tuple:
    """Replay ``rounds[w]`` rounds of worker w's ``pools[w]`` (cycled),
    each round the ``verbs`` in order, and compare what the program kept.

    ``kept[w]``: {round: [one result per GetRows or Get of the round, in
    order]}: a GetRows' rows, or a Get's own-row slice ``own[w]`` = the
    worker's [lo, hi). Returns (the reference table as float32 numpy, the
    number of kept elements that differ)."""
    table = torch.zeros((rows, cols), dtype=torch.float32, device=device)
    bad = 0
    for w, pool in enumerate(pools):
        lo, hi = own[w]
        dev_pool = [(torch.from_numpy(ids).to(device).long(),
                     torch.from_numpy(d).to(device)) for ids, d in pool]
        for i in range(rounds[w]):
            ids, d = dev_pool[i % len(pool)]
            got = iter(kept[w].get(i, ()))
            for verb in verbs:
                if verb == "AddRows":
                    table.index_add_(0, ids, d)
                elif i in kept[w]:
                    want = table[ids] if verb == "GetRows" else table[lo:hi]
                    bad += differ(next(got), want)
    return table.cpu().numpy(), bad


def differ(got: np.ndarray, want: torch.Tensor) -> int:
    g = torch.from_numpy(np.ascontiguousarray(got)).to(want.device)
    return int((g != want).sum())
