"""Aggregation's share of its roofline: the bound time of the window's
weighted sums (each weighted row read once, the result written once, 4 B a
value of the row width) at the card's HBM bandwidth, over the CUDA-event
time of every aggregation call in the window (``weighted_aggregate_rows``
in stepwise rounds, ``aggregate_rows_traced`` in fused ones)."""
import roofline


def read(ctx):
    nbytes, seconds = ctx.get("agg", (0, 0.0))
    if not nbytes or seconds <= 0:
        return None
    return 100.0 * roofline.bound_s(nbytes=nbytes) / seconds
