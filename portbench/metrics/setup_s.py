"""Set-up: process start to the window's start (host clock)."""

UNIT = "s"


def read(run):
    return run["setup_s"]
