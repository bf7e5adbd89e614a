"""What the per-layer metrics named after the port's spans read: the step
records of ``repro_torch.core.spans.steps()``, which the program keeps while
a ``torch.profiler`` session records.

A reading takes the last ``harness.PROFILE_STEPS`` records (the recorded
session's steps; the warm-up session's step comes before them) and gives the
mean a step.  It is ``None`` off the card (the CPU runs the kernels' plain
versions and has no CUDA events), for a program without spans, and where
the steps hold no such span or counter.  A span's stream ms are its kernels
plus the device's idle inside it; its host ms the host clock's."""

from __future__ import annotations

from portbench.harness import PROFILE_STEPS


def records(ctx) -> list[dict] | None:
    """The recorded session's step records, or ``None``."""
    if ctx.device_type != "cuda":
        return None
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    return spans.steps()[-PROFILE_STEPS:] or None


def total(record: dict, match, key: str, phases=None) -> float | None:
    """Σ ``key`` (``host_ms``, ``stream_ms``, ``top_host_ms``) over the spans
    whose name ``match`` accepts, in ``phases`` (all by default); ``None``
    where there is none or one has no such time."""
    out, found = 0.0, False
    for name, by_phase in record["spans"].items():
        if not match(name):
            continue
        for phase, d in by_phase.items():
            if phases is not None and phase not in phases:
                continue
            if d[key] is None:
                return None
            out, found = out + d[key], True
    return out if found else None


def per_step(ctx, pick) -> float | None:
    """The mean over the recorded steps of ``pick(record)``; ``None`` where
    a step gives ``None``."""
    recs = records(ctx)
    if recs is None:
        return None
    vals = [pick(r) for r in recs]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def span_ms(ctx, *names: str, key: str = "stream_ms", phases=None) -> float | None:
    """Mean ms a step of the spans ``names``, their phases summed."""
    return per_step(ctx, lambda r: total(r, lambda n: n in names, key, phases))
