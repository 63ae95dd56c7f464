"""The MoE app's sync phase (the pushes and the momentum updater's
applies on the tables' device plane) over the window, in %: the growth of
the app's counter ``moe.sync_s`` (the phase's device seconds, first to last
kernel, by CUDA events) over the window's seconds."""

UNIT = "%"


def read(run):
    moe = run.get("moe")
    if moe is None or "sync_s" not in moe:
        return None
    return moe["sync_s"] / run["window_s"] * 100.0
