"""Adam's share of its roofline: the bound time of the window's active
lane-steps (7 x 4 B a value of the row width: p, g, m, v read; p, m, v
written) at the card's HBM bandwidth, over the CUDA-event time of every
``cohort_step`` call in the window."""
import roofline


def read(ctx):
    nbytes, seconds = ctx.get("opt", (0, 0.0))
    if not nbytes or seconds <= 0:
        return None
    return 100.0 * roofline.bound_s(nbytes=nbytes) / seconds
