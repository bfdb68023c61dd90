"""Device time of the emission a traced request, in ms: the program's
``raster.emission`` spans over a request's two renders (the view and its
sun), each the interval between the CUDA events at its two ends; the mean
over the tracer's ``serve.request`` units. None when the program records
no such span."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("serve.request")
    s = u and u["spans"].get("raster.emission")
    return s["device_ms"] if s else None
