"""eskf_frontend_device_ms (ESKF front-end, ms/step): device time of the
kernels launched inside the benchmark's span around EskfVio._stereo_frontend
(rectify, ORB on both views, stereo match), on one eager step."""


def read(ctx):
    s = ctx.get("eager", {}).get("eskf_frontend")
    return None if not s else s * 1e3
