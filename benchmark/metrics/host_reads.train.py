"""Waits of the host for the card a traced step: the program's
``host_read`` count (every device-to-host read and every other call that
blocks on the card, by site); the mean over the tracer's ``train.step``
units. None when the program counts none."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("train.step")
    return u["reads"] if u else None
