"""Verbs a window of the engine carries: the growth of the
``server.window.verbs`` counter over the growth of the window count.
In the getall cell, where it moves ``ps_getall_rounds_per_s``."""

UNIT = "verbs"


def read(run):
    ps = run.get("ps")
    if ps is None or ps["windows"] <= 0:
        return None
    return ps["verbs"] / ps["windows"]
