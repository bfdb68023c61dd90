"""The (tile, Gaussian) pairs the program's emission made per step: the
``num_pairs`` of each of a traced step's renders, summed, per step."""


def read(ctx):
    pairs = ctx.run.counters.get("pairs")
    if not pairs or not ctx.run.traced_units:
        return None
    return pairs / ctx.run.traced_units
