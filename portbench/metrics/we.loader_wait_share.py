"""The WordEmbedding loader's hold on the trainer: the app's own
``loader_wait_s`` (the trainer waiting on the block queue), summed over
the window's ``train()`` calls, over the window's wall time, in %."""

UNIT = "%"


def read(run):
    we = run.get("we")
    if we is None:
        return None
    return we["loader_wait_s"] / run["window_s"] * 100.0
