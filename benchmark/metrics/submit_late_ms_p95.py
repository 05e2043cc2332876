"""submit_late_ms_p95 (benchmark loop, ms): the 95th percentile of how late
each tick of the live window started its upload after its due time: the
generator's own lateness. Nothing to read in a closed loop."""

import numpy as np


def read(ctx):
    late = ctx.get("late_s")
    if not late:
        return None
    return float(np.percentile(np.asarray(late, np.float64), 95)) * 1e3
