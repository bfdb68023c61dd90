"""Waits of the host for the card a traced request: the program's
``host_read`` count (the eight outputs' copies, the emission's demand and
masks, the blocking copies of host values); the mean over the tracer's
``serve.request`` units. None when the program counts none."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("serve.request")
    return u["reads"] if u else None
