"""The WordEmbedding step's kernels against the card's memory: the least
bytes the window's batches need (every unique row a batch touches in all
four tables read once and written once, plus the valid lanes' ids) over
the HBM peak, over the device time of every kernel in the window, in
%."""

from portbench.lib import roofline

UNIT = "%"


def read(run):
    tr, we = run.get("trace"), run.get("we")
    if tr is None or we is None or "bytes" not in we or tr["kernel_s"] <= 0:
        return None
    return roofline.share(we["bytes"] / roofline.HBM_BYTES_PER_S,
                          tr["kernel_s"])
