"""Host ms a round spent in cohort selection: the benchmark's span around
the strategy's ``select`` (stepwise rounds) and the fused body's
``scored_topk``, drained at both ends, summed over the window and divided
by its rounds."""


def read(ctx):
    ms = sum(b - a for n, a, b in ctx["spans"] if n == "select") / 1e6
    return ms / ctx["rounds"] if ctx["rounds"] else None
