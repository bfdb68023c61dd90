"""The 95th percentile of the timed window's request latencies, in ms:
every request of the window, on the host's clock. Kept per layer, beside
``view_ms``, because it swings between runs on a shared host by more than
any bound the benchmark may set."""

import statistics


def read(ctx):
    lat = ctx.run.latencies
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=20, method="inclusive")[-1] * 1e3
