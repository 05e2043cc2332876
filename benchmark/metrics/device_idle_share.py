"""device_idle_share (device, %): 1 - the device's busy time over the traced
steps (the union of its operations' intervals in the profiler's trace) /
the wall time of the same steps run without the profiler, just before."""


def read(ctx):
    steady, wall = ctx.get("steady"), ctx.get("wall_s")
    if not steady or not wall:
        return None
    return 100.0 * (1.0 - steady["busy_s"] / wall)
