"""The (tile, Gaussian) pairs the program's emission made per dual step for
the MSI camera: the ``num_pairs`` of a traced step's renders at the MSI
canvases (its main and random camera's and its sun's), summed, per step."""


def read(ctx):
    pairs = ctx.run.counters.get("pairs_msi")
    if not pairs or not ctx.run.traced_units:
        return None
    return pairs / ctx.run.traced_units
