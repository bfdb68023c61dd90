"""Device time of the resamples a traced step, in ms: the program's
``resample`` and ``resample.bwd`` spans (``ops/resample.grid_sample``,
forward and its deterministic backward, the sun's and the random
camera's), each the interval between the CUDA events at its two ends; the
mean over the tracer's ``train.step`` units. None when the program records
no such span."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("train.step")
    s = [u["spans"][n] for n in ("resample", "resample.bwd")
         if u and n in u["spans"]]
    return sum(x["device_ms"] for x in s) if s else None
