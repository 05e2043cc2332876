"""host_calls_per_step (compiled step, calls/step): host API calls that put
work on the device (kernel launches, graph launches, copies) over the
traced steps, per step (tools/profile_ops.py's rule, trace.LAUNCH_APIS)."""


def read(ctx):
    steady = ctx.get("steady")
    if not steady or not ctx.get("steps"):
        return None
    return steady["host_calls"] / ctx["steps"]
