"""Share of the traced window in which the card was idle while the host
was inside a local step: the idle gaps (the window less the union of the
card's operations, placed on the host clock through their launch calls by
``hostclock.place``) intersected with the program's ``step`` spans."""


def read(ctx):
    tr, spans = ctx.get("trace"), ctx.get("program_spans", ())
    if not tr or "idle" not in tr or tr["window_s"] <= 0:
        return None
    steps = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "step")
    if not steps:
        return None
    ns, k = 0, 0
    for a, b in sorted(tr["idle"]):
        while k < len(steps) and steps[k][1] <= a:
            k += 1
        j = k
        while j < len(steps) and steps[j][0] < b:
            ns += max(0, min(b, steps[j][1]) - max(a, steps[j][0]))
            j += 1
    return 100.0 * ns / 1e9 / tr["window_s"]
