"""The share of a training step in which no operation runs on the device:
1 - the device's busy time a profiled step (the union of its events'
intervals) over the median wall time of the run's steps that were not
profiled (the profiler's host work slows the profiled ones, not the
device's)."""

from benchmark.metrics._trace import device_busy


def read(ctx):
    busy, _ = device_busy(ctx.events)
    wall = ctx.counters.get("unit_wall_s")
    if busy <= 0 or not wall or not ctx.units:
        return None
    return 1.0 - busy / ctx.units / wall
