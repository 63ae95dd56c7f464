"""The engine's mean window (``sync/server.py``): the growth of the
``server.window.latency_s`` histogram's sum over the growth of its count
across the window, in ms.
In the getall cell, where it moves ``ps_getall_rounds_per_s``."""

UNIT = "ms"


def read(run):
    ps = run.get("ps")
    if ps is None or ps["windows"] <= 0:
        return None
    return ps["engine_window_s"] / ps["windows"] * 1e3
