"""The whole step's (or request's) share of the cards' FP32 peak: the
operations counted from its inputs and state (counts.py) over the traced
window's host-clock length."""

from benchmark.counts import mfu


def read(ctx):
    return mfu(ctx)
