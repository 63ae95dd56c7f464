"""The MoE training step's share of the card's bfloat16 dense peak (the
type its matmuls run in): the window's FLOPs over the window's seconds
times the peak, in %. The FLOPs are counted by the benchmark
(``lib/roofline_moe.py``) from the shapes, the tokens and the app's count
of token-expert pairs on held experts; the window is the traced run's."""

from portbench.lib import roofline

UNIT = "%"


def read(run):
    moe = run.get("moe")
    if (moe is None or run.get("trace") is None or "flops" not in moe
            or "peaks" not in moe):
        return None
    return roofline.share(moe["flops"] / moe["peaks"]["bf16_flops"],
                          run["window_s"])
