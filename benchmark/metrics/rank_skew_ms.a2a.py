"""How far the ranks' steps differ on the host, in ms: each rank's mean
host interval of the program's ``train.step`` span over the traced run's
steps recorded with no profiler on any rank, the largest less the
smallest. None when the program records no such span."""


def read(ctx):
    return ctx.run.counters.get("rank_skew_ms")
