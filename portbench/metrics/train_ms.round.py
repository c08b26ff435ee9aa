"""Host ms a round spent in cohort training: the benchmark's span around
every trainer call (``train_cohort_indexed``, ``train_cohort_rows``),
drained at both ends, summed over the window and divided by its rounds."""


def read(ctx):
    ms = sum(b - a for n, a, b in ctx["spans"] if n == "train") / 1e6
    return ms / ctx["rounds"] if ctx["rounds"] else None
