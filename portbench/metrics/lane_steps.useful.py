"""Share of the lane-steps the local-training loop ran that a lane's budget
asked for: the window's ``lane_steps_useful`` over its ``lane_steps_run``
(``CohortTrainer``'s counters, read at the window's open and close). The
rest ran on pad lanes or on lanes past their budget, masked in the
optimizer."""


def read(ctx):
    c = ctx.get("counters")
    if not c or not c.get("lane_steps_run"):
        return None
    return 100.0 * c["lane_steps_useful"] / c["lane_steps_run"]
