"""Device time of the a2a path's pair exchange a step on rank 0, in ms:
the program's ``a2a.exchange`` spans (``parallel/sharded_raster.
_exchange``: the all_to_all_single of the windows, forward and backward, of
every render), each the interval between the CUDA events at its two ends,
so it holds the wait for the slowest rank too; the mean over rank 0's
``train.step`` units of the traced run's steps recorded with no profiler.
None when the program records no such span."""


def read(ctx):
    return ctx.run.counters.get("exchange_ms")
