"""A uniform pass's results in film order: the CUDA kernel's wrapper.

The kernel (csrc/film.cu) replaces no TPU kernel: the JAX driver
unpermutes a pass's Morton-order results on the host
(pyrenderer_tpu/render/driver.py). Here render/driver.py hands each
chunk's sums and sums of squares to ``write``, which puts them at each
lane's pixel of a (2, H, W, 3) staging tensor in the film's layout (row 0
the top of the image), so that the pass reaches the host in one copy and
in film order.

``write`` chooses the path from the device of its operands, as every
wrapper chooses: one launch of the kernel for CUDA tensors (float32 or
float64), counted in ``write.launches`` and, for the program's own
tracing, as one ``film_kernel`` (utils/profiling.count); the plain twin
``write_ref`` (``index_put_`` on flat views, the same contract) for CPU
tensors, counted in ``write.twin_calls``.
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.utils.profiling import count


def write_ref(out, sums, sqs, pixel_x, pixel_y) -> None:
    """The plain twin of ``write``: out[0] at each lane's pixel gets 0 + its
    sum, out[1] 0 + its square; raises for a pixel outside the film."""
    _, h, w, _ = out.shape
    outside = (pixel_x < 0) | (pixel_x >= w) | (pixel_y < 0) | (pixel_y >= h)
    if bool(outside.any()):
        raise ValueError(f"film: {int(outside.sum())} lanes have a pixel outside the "
                         f"{w} x {h} film")
    idx = (h - 1 - pixel_y) * w + pixel_x
    flat = out.view(2, h * w, 3)
    flat[0].index_put_((idx,), 0.0 + sums)
    flat[1].index_put_((idx,), 0.0 + sqs)


def write(out, sums, sqs, pixel_x, pixel_y) -> None:
    """Put a chunk's per-lane sums (N, 3) and sums of squares (N, 3), of the
    lanes at pixels (pixel_x, pixel_y) (N,) int64, y from the bottom, into
    the staging tensor `out` (2, H, W, 3) of their dtype (float32 or
    float64): 0 + sum at out[0][H - 1 - y, x], 0 + square at out[1][H - 1 -
    y, x] (a -0 turns +0). The lanes are distinct pixels inside the film: a
    pixel outside it raises in the twin and stops the kernel (the next call
    that waits for the device raises). One launch for CUDA tensors, none
    for no lanes; never waits for the device."""
    dev, n = sums.device, sums.shape[0]
    if out.dim() != 4 or out.shape[0] != 2 or out.shape[3] != 3 or not out.is_contiguous():
        raise ValueError(f"film: out is a {tuple(out.shape)} tensor, the pass takes a "
                         f"contiguous (2, H, W, 3) one")
    if (out.dtype not in (torch.float32, torch.float64)
            or any(x.device != dev or x.dtype != out.dtype or tuple(x.shape) != (n, 3)
                   for x in (sums, sqs))
            or any(p.device != dev or p.dtype != torch.int64 or tuple(p.shape) != (n,)
                   for p in (pixel_x, pixel_y))
            or out.device != dev):
        raise ValueError(f"film: sums {sums.dtype} {tuple(sums.shape)} and squares {sqs.dtype} "
                         f"{tuple(sqs.shape)} on {sums.device}, pixels {pixel_x.dtype} "
                         f"{tuple(pixel_x.shape)} and {pixel_y.dtype} {tuple(pixel_y.shape)}, "
                         f"out {out.dtype} on {out.device}: the pass takes (N, 3) sums and "
                         f"squares of out's dtype (float32 or float64), (N,) int64 pixels, "
                         f"on one device")
    if not build.on_cuda(sums, "film"):
        write_ref(out, sums, sqs, pixel_x, pixel_y)
        write.twin_calls += 1
        return
    s, q = sums.contiguous(), sqs.contiguous()
    px, py = pixel_x.contiguous(), pixel_y.contiguous()
    _, h, w, _ = out.shape
    if n:
        build.launch("pr_film", dev, n, s.data_ptr(), q.data_ptr(), px.data_ptr(),
                     py.data_ptr(), w, h, int(out.dtype == torch.float64), out.data_ptr())
        write.launches += 1
        count("film_kernel")


def reset_counters() -> None:
    write.launches = 0
    write.twin_calls = 0


reset_counters()
