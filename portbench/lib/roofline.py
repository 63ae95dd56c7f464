"""The operations and bytes a cell's work needs, counted from its inputs
(never read from the program), and the share of a bound they give."""

from portbench.lib.peaks import H100

HBM_BYTES_PER_S = H100["hbm_bytes_per_s"]


def we_flops(valid_lanes: int, touched_rows: int, dim: int,
             negative: int) -> int:
    """SGNS under AdaGrad: per valid lane 6 * D * (1 + K) (the dot
    products, the hidden error and the output rows' gradient, each a
    multiply and an add); per touched row of a table 6 * D (g2 += g * g,
    the square root, the divide, the rate, the add)."""
    return 6 * dim * (1 + negative) * valid_lanes + 6 * dim * touched_rows


def we_bytes(valid_lanes: int, touched_rows: int, dim: int,
             negative: int) -> int:
    """Each unique row a batch touches, of a table and of its AdaGrad
    state, read once and written once (float32), plus every valid lane's
    context, center and negative ids (int32)."""
    return 16 * dim * touched_rows + 4 * (2 + negative) * valid_lanes


def share(least_s: float, took_s: float) -> float:
    """The least time over the time taken, in %."""
    return least_s / took_s * 100.0
