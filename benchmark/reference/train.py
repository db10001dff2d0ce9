"""The plain reference of the training cell: inverse-rendering steps with
the reference renderer of benchmark/reference/render.py under autograd.

A step renders every pixel once (sample 0 of the step's seed) in chunks
of CHUNK row-major pixels, takes the mean squared error against the
target, differentiates each chunk's share before the next is rendered and
sums the gradients, then takes one SGD step on (vertices, albedo,
emission), each with its own rate. The reference estimator never reads
emission, so its gradient is 0. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.render import Reference

CHUNK = 1 << 16


def grey_albedo(albedo):
    """The target's albedo: the reddest material made grey (0.5, 0.5, 0.5)."""
    grey = np.array(albedo, np.float32, copy=True)
    grey[int(np.argmax(grey[:, 0] - grey[:, 1]))] = 0.5
    return grey


def pixel_grid(w: int, h: int, device):
    """All pixels, row-major from the bottom row: (x, y) int64 (W*H,)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def render(ref: Reference, seed: int, px, py):
    """(N, 3) radiance of sample 0 of every pixel, chunk by chunk."""
    return torch.cat([ref.trace(px[s:s + CHUNK], py[s:s + CHUNK],
                                torch.zeros_like(px[s:s + CHUNK]), seed)
                      for s in range(0, px.shape[0], CHUNK)])


def loss_and_grads(ref: Reference, params, target, seed: int, px, py, keep=None):
    """(loss, [grad of vertices, of albedo, of emission]) of the mean squared
    error against `target`; `keep(sl)` (a fault) picks the pixels of a
    chunk that count, the mean taken over them."""
    leaves = [p.detach().requires_grad_() for p in params]
    grads = [torch.zeros_like(p) for p in leaves]
    loss = torch.zeros((), dtype=target.dtype, device=target.device)
    n = target.numel() if keep is None else sum(
        int(keep(slice(s, s + CHUNK)).sum()) * 3 for s in range(0, px.shape[0], CHUNK))
    for s in range(0, px.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        with torch.enable_grad():
            # the rows anew for each chunk: its backward frees their graph
            ref.set_params(leaves[0], leaves[1])
            img = ref.trace(px[sl], py[sl], torch.zeros_like(px[sl]), seed)
            d2 = (img - target[sl]) ** 2
            if keep is not None:
                d2 = d2[keep(sl)]
            part = torch.sum(d2) / n
        loss = loss + part.detach()
        for g, d in zip(grads, torch.autograd.grad(part, leaves, allow_unused=True,
                                                   materialize_grads=True)):
            g += d
    return loss, grads


def steps(ref: Reference, params, target, seeds, lr, px, py, keep=None):
    """The SGD steps of `seeds` (one a step) from `params`: (losses,
    first gradients, params after each step)."""
    losses, history, first = [], [], None
    for seed in seeds:
        loss, grads = loss_and_grads(ref, params, target, seed, px, py, keep)
        if first is None:
            first = [g.detach() for g in grads]
        params = tuple((p - r * g).detach() for p, g, r in zip(params, grads, lr))
        losses.append(float(loss))
        history.append(params)
    return losses, first, history
