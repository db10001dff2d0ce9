"""Rendering a field of pixels and one inverse-rendering training step.

Counterpart of pyrenderer_tpu/dist/render.py:119-163 in one process, with
the JAX names kept: ``pixel_grid``, ``render_field`` (the JAX package's
``render_field_sharded`` without its mesh) and ``train_step``. They run on
the device of the scene's tensors. Splitting the pixels and the samples
over devices with torch.distributed (the JAX package's "dp" and "sp" mesh
axes and its psum) is ROADMAP A13; until then no function here takes a
mesh.

Gradients are torch autograd's (core/integrator.py states what is
differentiable); the kernels take detached inputs, so backward launches
no kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.integrator import (
    TraceTables,
    maybe_build_accel,
    render_sample,
    resolve_backend,
)
from pyrenderer_tpu_torch.scene.types import Camera, Scene

# pixels per rendered chunk of train_step, render_image's default
CHUNK = 1 << 16


def pixel_grid(camera: Camera):
    """All pixel coordinates (x right, y up from the bottom), flattened
    row-major: two (W*H,) int64 tensors on the camera's device."""
    w, h = camera.resolution
    device = camera.iview.device
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def render_field(scene: Scene, camera: Camera, cfg: RenderConfig, pixel_x, pixel_y,
                 accel=None):
    """Mean radiance (N, 3) over cfg.spp samples for the given pixels.

    The backend is "auto", resolved once for all samples (resolve_backend):
    the whole-table kernels ("cuda") on a GPU and "brute" on the CPU up to
    AUTO_BRUTE_MAX_TRIS faces, above them the backend of `accel`, or the
    sweep ("cluster", GPU) or BVH (CPU) built here. The JAX package maps
    "cluster_binned" back to "cluster" at this point, but its TraceTables
    applies PYRENDERER_CLUSTER_IMPL=binned again, so both packages trace the
    binned path under that variable."""
    backend = resolve_backend("auto", scene.faces.shape[0], scene.vertices.device, accel)
    tables = TraceTables(scene, cfg, backend, accel=accel)
    total = render_sample(scene, camera, cfg, cfg.seed, 0, pixel_x, pixel_y, tables=tables)
    for s in range(1, cfg.spp):
        total = total + render_sample(scene, camera, cfg, cfg.seed, s, pixel_x, pixel_y,
                                      tables=tables)
    return total / cfg.spp


def train_step(params: Tuple, scene: Scene, camera: Camera, cfg: RenderConfig, target,
               pixel_x, pixel_y, lr, accel=None):
    """One inverse-rendering step: render_field -> mean squared error
    against `target` (N, 3) -> one SGD step on (vertices, albedo, emission).

    params: (vertices, albedo, emission), replacing the scene's. lr: a
    scalar, or (lr_vertices, lr_albedo, lr_emission) to give each its own
    step; 0 freezes a parameter, which takes no gradient and comes back as
    the same tensor (p - 0 * g would be NaN where g is inf).
    accel: an accelerator for large scenes (core.integrator
    .maybe_build_accel; built here once when the scene needs one and none
    is given), passed through unchanged. The hit selection is detached, so
    an accel built from the current vertices stays a valid traversal oracle
    for the small vertex moves of a training step.
    The pixels are rendered CHUNK at a time, as render_image renders
    them, and each chunk's share of the loss is differentiated before the
    next is rendered, so the autograd graph holds one chunk at most; the
    gradients are summed over the chunks.
    Returns (loss, new_params), detached."""
    lrs = tuple(lr) if isinstance(lr, (tuple, list)) else (lr, lr, lr)
    leaves = [p.detach().requires_grad_(step != 0) for p, step in zip(params, lrs)]
    vertices, albedo, emission = leaves
    s = scene._replace(vertices=vertices, albedo=albedo, emission=emission)
    accel = maybe_build_accel(s, "auto", accel)
    trained = [i for i, step in enumerate(lrs) if step != 0]
    grads = [torch.zeros_like(leaves[i]) for i in trained]
    loss = torch.zeros((), dtype=target.dtype, device=target.device)
    for start in range(0, pixel_x.shape[0], CHUNK):
        sl = slice(start, start + CHUNK)
        with torch.enable_grad():
            img = render_field(s, camera, cfg, pixel_x[sl], pixel_y[sl], accel=accel)
            part = torch.sum((img - target[sl]) ** 2) / target.numel()
        loss = loss + part.detach()
        if trained:
            for g, d in zip(grads, torch.autograd.grad(
                    part, [leaves[i] for i in trained], allow_unused=True,
                    materialize_grads=True)):
                g += d
    new_params = list(params)
    for i, g in zip(trained, grads):
        new_params[i] = (params[i] - lrs[i] * g).detach()
    return loss, tuple(new_params)
