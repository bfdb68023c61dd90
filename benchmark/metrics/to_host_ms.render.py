"""Host time of the copy-out a traced request, in ms: the program's
``serve.to_host`` span (``pipeline.render_view_full`` turning its eight
outputs into cropped numpy arrays: the device-to-host copies into pageable
memory and their page faults); the mean over the tracer's
``serve.request`` units. On the host's clock, which the profiler slows.
None when the program records no such span."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("serve.request")
    s = u and u["spans"].get("serve.to_host")
    return s["host_ms"] if s else None
