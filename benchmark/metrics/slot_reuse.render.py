"""Share of the traced requests whose copy-out reused a page-locked host
slot, in %: the program's ``serve.slot.reused`` count (one a request whose
eight outputs went into a slot that served an earlier request; the others
count ``serve.slot.new`` or ``serve.slot.fallback``) over the tracer's
``serve.request`` units. None when the program counts no copy-out (no
slots, or the CPU's path)."""


def per_unit(unit):
    """The program tracer's means a unit, or None (no tracer, no unit)."""
    from eogs2_tpu_torch import observability

    tracer = getattr(observability, "tracer", None)
    return tracer.per_unit(unit) if tracer is not None else None


def read(ctx):
    u = per_unit("serve.request")
    counts = (u or {}).get("counts") or {}
    if not any(k.startswith("serve.slot.") for k in counts):
        return None
    return 100.0 * counts.get("serve.slot.reused", 0.0)
