"""Host microseconds a local step: the mean length of the program's
``step`` spans in the window (``repro_torch.tracing``, undrained: the
host's dispatch of the gather, the vmapped gradients and the optimizer,
and any wait it met)."""


def read(ctx):
    steps = [s.end_ns - s.start_ns for s in ctx.get("program_spans", ())
             if s.name == "step"]
    return sum(steps) / len(steps) / 1e3 if steps else None
