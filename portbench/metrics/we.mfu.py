"""The whole WordEmbedding step's share of the card's float32 peak (the
precision the step computes in): the FLOPs the window's lanes need, over
the window's seconds times the peak, in %. The lanes and touched rows
are counted by the benchmark (``drivers/we_sgns_1bw.py``, ``per_layer``)
from the tokens and the draws; ``lib/roofline.py`` says what a lane and
a row cost."""

from portbench.lib import roofline

UNIT = "%"


def read(run):
    we = run.get("we")
    if we is None or "flops" not in we or "peaks" not in we:
        return None
    return roofline.share(we["flops"] / we["peaks"]["fp32_flops"],
                          run["window_s"])
