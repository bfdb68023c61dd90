"""Device time of the PAN camera's part of a traced dual step, in ms: the
program's ``train.forward.pan`` span (``train.make_train_step``'s loop over
the modalities: the camera's three renders, resamples, shading, flow phase
and losses), the interval between the CUDA events at its two ends; the mean
over the tracer's ``train.step`` units (the traced steps and the
host-named ones after them). None when the program records no such span."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("train.step")
    s = u and u["spans"].get("train.forward.pan")
    return s["device_ms"] if s else None
