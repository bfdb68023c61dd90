"""Device time of the emission a traced step, in ms: the program's
``raster.emission`` spans (``ops/fused_raster.sort_pairs``: emit_pairs,
the sort and the tiles' ranges) over a step's three renders, each the
interval between the CUDA events at its two ends, so it holds the idle
inside it too; the mean over the tracer's ``train.step`` units (the traced
steps and the host-named ones after them). None when the program records
no such span."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("train.step")
    s = u and u["spans"].get("raster.emission")
    return s["device_ms"] if s else None
