"""The device's busy time in a profile: the union of its events' intervals.

Copied from pyrenderer_tpu_torch/utils/profiling.device_busy, so
that a change to the program cannot change the yardstick; here over the
harness's events (seconds), and it also returns the union's intervals,
whose gaps are the device's idle time.
"""


def device_busy(events) -> tuple:
    """(busy s, [[start, end], ...] of the union) of the device events."""
    device = sorted((e.start, e.end) for e in events if e.device)
    busy, end, spans = 0.0, None, []
    for start, stop in device:
        if end is None or start > end:
            busy += stop - start
            spans.append([start, stop])
            end = stop
        elif stop > end:
            busy += stop - end
            spans[-1][1] = stop
            end = stop
    return busy, spans
