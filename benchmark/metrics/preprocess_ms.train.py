"""Device time of the per-Gaussian preprocess a traced step, in ms: the
program's ``raster.preprocess`` spans (``rasterizer.preprocess``: the
projection, covariance, conic, radius and tile rect of every Gaussian) and
``raster.preprocess.bwd`` spans (its backward), each the interval between
the CUDA events at its two ends, summed over a step's renders; the mean
over the tracer's ``train.step`` units. A program whose backward records
no span (autograd's own backward of the plain tensor code) reads the
forward alone: its levels measure less work than those of a program with
both spans, and understate its preprocess. None when the program records
neither span."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("train.step")
    s = [u["spans"][n] for n in ("raster.preprocess", "raster.preprocess.bwd")
         if u and n in u["spans"]]
    return sum(x["device_ms"] for x in s) if s else None
