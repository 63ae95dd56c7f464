"""The getall cell's rate: every worker's completed rounds (each a whole
Get, an AddRows and a whole Get) over the window's wall time (host
clock)."""

UNIT = "rounds/s"


def read(run):
    ps = run.get("ps")
    return None if ps is None else ps["rounds"] / run["window_s"]
