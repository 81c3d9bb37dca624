"""The program's own spans and counters (pfb_tpu_torch/utils/profiling.py),
recorded while the traced window's profiler runs, as the readers under
metrics/ take them. Where the program has none (a checkout from before
them), ``tracer`` gives None and those readers return nothing."""


def tracer():
    """(records, counters) of the program's tracer, or None."""
    try:
        from pfb_tpu_torch.utils.profiling import counters, records
    except ImportError:
        return None
    return records(), counters()


def per_unit(ctx, total):
    """``total`` over the units the window finished (spotless majors,
    fluxmop calls)."""
    return total / ctx["units"] if ctx["units"] else None


def host_ms(recs, names):
    """Host milliseconds of the spans named in ``names``; None where
    there is none."""
    ms = [r.host_ms for r in recs if r.name in names]
    return sum(ms) if ms else None


def device_ms(recs, prefix):
    """Device milliseconds of the spans whose name starts with
    ``prefix``; None where none has a device interval."""
    ms = [r.device_ms for r in recs
          if r.name.startswith(prefix) and r.device_ms is not None]
    return sum(ms) if ms else None


def per_count(t, ms, counter):
    """``ms`` over the count of ``counter`` in the tracer state ``t``;
    None where either is missing."""
    n = t[1].get(counter, 0)
    return ms / n if ms is not None and n else None
