"""Kernel launches a batch step: the kernels the device trace saw in the
window over the growth of ``DevicePairsTrainer.batches``."""

UNIT = "launches"


def read(run):
    tr, we = run.get("trace"), run.get("we")
    if tr is None or we is None or we["batches"] <= 0:
        return None
    return tr["kernel_n"] / we["batches"]
