"""Device time of the device-to-host copies per traced request (the
outputs that render_view_full hands back as numpy arrays), in ms."""


def read(ctx):
    if not ctx.trace or not ctx.run.traced_units:
        return None
    s = ctx.trace.seconds("Memcpy DtoH")
    return 1e3 * s / ctx.run.traced_units if s else None
