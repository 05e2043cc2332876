"""filter_device_ms (MSCKF filter, ms/step): device time of the kernels
launched inside the benchmark's span around MSCKF.step, on one eager step
at the cell's shapes."""


def read(ctx):
    s = ctx.get("eager", {}).get("filter")
    return None if not s else s * 1e3
