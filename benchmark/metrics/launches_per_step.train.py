"""Device events (kernels, copies, fills) a training step, over the
profiled steps: dist/render.py's train_step and loss_and_grads, the
forward's glue and kernels and autograd's backward. A count: it repeats
for a seed."""


def read(ctx):
    n = len(ctx.device_events())
    return n / ctx.units if n and ctx.units else None
