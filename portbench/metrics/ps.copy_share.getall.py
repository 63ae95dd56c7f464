"""The server tables' transfers: device time of the host-to-device and
device-to-host copies over the traced window, in %.
In the getall cell, where it moves ``ps_getall_rounds_per_s``."""

UNIT = "%"


def read(run):
    tr = run.get("trace")
    if tr is None or run.get("ps") is None:
        return None
    return (tr["h2d_s"] + tr["d2h_s"]) / run["window_s"] * 100.0
