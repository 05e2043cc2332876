"""frontend_device_ms (MSCKF front-end, ms/step): device time of the kernels
launched inside the benchmark's span around StereoTracker.step, on one
eager step at the cell's shapes (it launches the kernels the graph holds)."""


def read(ctx):
    s = ctx.get("eager", {}).get("frontend")
    return None if not s else s * 1e3
