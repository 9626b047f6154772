"""The 95th percentile, over every request the window served, of the time
from its submission to its token on the host, in ms."""

import statistics


def read(ctx):
    latency = ctx.window.get("latency_s") or []
    if len(latency) < 2:
        return None
    return 1000.0 * statistics.quantiles(latency, n=20)[18]
