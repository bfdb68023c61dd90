"""The device's idle share of the traced window (rank 0's on several
cards): 100 (1 - busy / window), busy the union of its operations."""

from benchmark.counts import idle


def read(ctx):
    return idle(ctx)
