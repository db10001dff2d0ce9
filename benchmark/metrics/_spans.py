"""The program's spans a driver recorded after its window, as the readers
of program_span and program_counter metrics take them.

A driver that records them (drivers/progressive_pbrt.py) puts into the
tracer's counters "spans": one (name, start_ns, end_ns, parent, unit,
syncs) a span in the order opened, parent and unit indices into that
list (the span open around it, the top-level span it belongs to); and
"syncs_counted": whether the host's waits for the device were counted.
The arithmetic is Recorder.summary's (pyrenderer_tpu_torch/
utils/profiling.py), copied so that a change to the program cannot change
the yardstick: over the finished top-level spans named `unit`, a span's
time is its duration, its self time the duration less the part its child
spans cover.
"""

NAME, START, END, PARENT, UNIT, SYNCS = range(6)


def units(ctx, unit: str = "pass") -> tuple:
    """(the recorded spans, the indices of the finished top-level spans
    named `unit`); ([], set()) where the driver recorded none."""
    spans = ctx.counters.get("spans") or []
    tops = {i for i, s in enumerate(spans) if s[UNIT] == i and s[NAME] == unit and s[END]}
    return spans, tops


def self_ns(spans, i: int, children: dict) -> int:
    """Span i's duration less the part of its interval its children cover."""
    s = spans[i]
    covered, end = 0, s[START]
    for a, b in sorted((spans[c][START], spans[c][END]) for c in children.get(i, ())):
        a, b = max(a, end), min(b, s[END])
        if b > a:
            covered += b - a
            end = b
    return s[END] - s[START] - covered


def ms_per_unit(ctx, names, self_time: bool = False, unit: str = "pass"):
    """Host milliseconds a unit inside the spans named in `names` (their
    self time with `self_time`); None where none of them was recorded."""
    spans, tops = units(ctx, unit)
    picked = [i for i, s in enumerate(spans) if s[UNIT] in tops and s[NAME] in names]
    if not picked:
        return None
    children = {}
    for i, s in enumerate(spans):
        if s[PARENT] is not None:
            children.setdefault(s[PARENT], []).append(i)
    total = sum(self_ns(spans, i, children) if self_time else spans[i][END] - spans[i][START]
                for i in picked)
    return total / len(tops) / 1e6


def syncs_per_unit(ctx, unit: str = "pass"):
    """The host's waits for the device a unit, charged to its spans; None
    where they were not counted."""
    spans, tops = units(ctx, unit)
    if not tops or not ctx.counters.get("syncs_counted"):
        return None
    return sum(s[SYNCS] for s in spans if s[UNIT] in tops) / len(tops)
