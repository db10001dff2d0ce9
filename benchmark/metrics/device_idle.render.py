"""The share of a pass in which no operation runs on the device: 1 - the
device's busy time a profiled pass (the union of its events' intervals)
over the median wall time of the run's passes that were not profiled.

The profiler's own host work slows a profiled pass (1.6-1.8x at the
Cornell box's 55,000 launches a pass) but not the device's work, so the
busy time is read from the profiled passes and the wall from the others.
"""

from benchmark.metrics._trace import device_busy


def read(ctx):
    busy, _ = device_busy(ctx.events)
    wall = ctx.counters.get("unit_wall_s")
    if busy <= 0 or not wall or not ctx.units:
        return None
    return 1.0 - busy / ctx.units / wall
