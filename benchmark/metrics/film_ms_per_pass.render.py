"""Host milliseconds a pass spends in Film.add_pass (core/film.py): the
harness's span around the film update, over the profiled passes."""


def read(ctx):
    spans = ctx.spans.get("film.add_pass")
    if not spans or not ctx.units:
        return None
    return sum(spans) * 1e3 / ctx.units
