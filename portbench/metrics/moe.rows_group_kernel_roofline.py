"""The momentum updater's row kernels in the MoE cell against the card's
memory: the least bytes of the window's pushed rows (every held expert's
row a step pushes and every distinct token row of the step, each with its
momentum row, read once and written once: ``lib/roofline_moe.py``
``row_bytes``) over the HBM peak, over the device time of the row kernels
that gather the rows and set them back (``rows_group_kernel<0, ...>`` and
``<3, ...>``, from the trace's ten costliest device operations), in %.
None where the trace does not show both."""

from portbench.lib import roofline

UNIT = "%"
KERNELS = ("rows_group_kernel<0,", "rows_group_kernel<3,")


def read(run):
    tr, moe = run.get("trace"), run.get("moe")
    if tr is None or moe is None or "row_bytes" not in moe:
        return None
    ops = tr.get("breakdown", {}).get("device_ops", [])
    took = [sum(s for n, s in ops if k in n) for k in KERNELS]
    if not all(took):
        return None
    return roofline.share(moe["row_bytes"] / roofline.HBM_BYTES_PER_S,
                          sum(took))
