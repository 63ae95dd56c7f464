"""The device's idle share in the PS cells: 1 minus the union of the
device's kernel, copy and memset intervals over the traced window, in
%.
In the getall cell, where it moves ``ps_getall_rounds_per_s``."""

UNIT = "%"


def read(run):
    tr = run.get("trace")
    if tr is None or run.get("ps") is None:
        return None
    return (1.0 - tr["busy_s"] / run["window_s"]) * 100.0
