"""hand_kernels_roofline (hand kernels, %): the least time of the traced
steps' hand-kernel launches (benchmark/roofline.py, from each launch's call
shape as the program's launch counters give it) over their device time in
the trace, by kernel name. Nothing to read where no hand kernel ran."""


def read(ctx):
    least, spent = ctx.get("least_s", 0.0), ctx.get("hand_s", 0.0)
    if not least or not spent:
        return None
    return 100.0 * least / spent
