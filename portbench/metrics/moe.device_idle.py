"""The device's idle share in the MoE cells: 1 minus the union of the
device's kernel, copy and memset intervals over the traced window, in %."""

UNIT = "%"


def read(run):
    tr = run.get("trace")
    if tr is None or run.get("moe") is None:
        return None
    return (1.0 - tr["busy_s"] / run["window_s"]) * 100.0
