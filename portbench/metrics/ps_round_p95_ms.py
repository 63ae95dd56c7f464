"""The 95th percentile over every round of every worker in the window,
host clock from the round's first verb to its last reply."""

import numpy as np

UNIT = "ms"


def read(run):
    ps = run.get("ps")
    if ps is None or not ps["round_ms"]:
        return None
    return float(np.percentile(ps["round_ms"], 95))
