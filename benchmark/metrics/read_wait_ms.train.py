"""Host time blocked in the program's ``host_read`` calls a traced step, in
ms; the mean over the tracer's ``train.step`` units. On the host's clock,
which the profiler slows (a baseogs step on an H100: 154 ms traced against
118-132 untraced); a wait mostly lasts until the card drains its queue, so
it reads the card's time more than the host's. None when the program
counts none."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("train.step")
    return u["read_wait_ms"] if u else None
