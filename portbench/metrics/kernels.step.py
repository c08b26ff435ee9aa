"""Device operations a local step: the card's kernels, copies and memsets
whose launch calls lie inside the program's ``cohort`` spans (on the host
clock the spans share), over the ``step`` spans inside those cohorts. It
holds the cohort's draw and landing too, spread over its steps."""
import numpy as np


def read(ctx):
    tr, spans = ctx.get("trace"), ctx.get("program_spans", ())
    if not tr or "launch" not in tr:
        return None
    steps = sum(1 for s in spans if s.name == "step")
    if not steps:
        return None
    ls = tr["launch"]                        # launch calls' starts, sorted
    return sum(int(np.searchsorted(ls, s.end_ns) - np.searchsorted(ls, s.start_ns))
               for s in spans if s.name == "cohort") / steps
