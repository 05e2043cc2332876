"""eskf_filter_device_ms (ESKF filter, ms/step): device time of the kernels
launched inside the benchmark's span around eskf_frame_step (propagation
and the 512 sequential updates), on one eager step."""


def read(ctx):
    s = ctx.get("eager", {}).get("eskf_filter")
    return None if not s else s * 1e3
