"""Host time blocked in the program's ``host_read`` calls a traced
request, in ms; the mean over the tracer's ``serve.request`` units. On the
host's clock, which the profiler slows. None when the program counts
none."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("serve.request")
    return u["read_wait_ms"] if u else None
