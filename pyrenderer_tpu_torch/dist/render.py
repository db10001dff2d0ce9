"""Rendering a field of pixels and the inverse-rendering step, in one
process or sharded over the ranks of a torch.distributed world.

Counterpart of pyrenderer_tpu/dist/render.py, with the JAX names kept:
``pixel_grid``, ``render_field`` (the JAX package's
``render_field_sharded`` without its mesh), ``make_mesh``,
``render_field_sharded`` and ``train_step``.

The JAX package shards over a ("dp", "sp") device mesh inside one SPMD
program. Here every rank is a process with one device (multihost.py brings
the world up), and the mesh is a torch DeviceMesh with the same axis
names: pixel blocks split over "dp", samples per pixel over "sp". Radiance
sums are associative, so the sample split costs one all-reduce over "sp"
per chunk of pixels (the JAX package's psum); the RNG counters are global,
so the sharded render is the same function as render_field.

Gradients are torch autograd's (core/integrator.py states what is
differentiable); the kernels take detached inputs, so backward launches
no kernel. torch.distributed's collectives have no autograd, so the
collectives that carry gradients are the autograd Functions below; each
says which losses its backward is right for.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.integrator import (
    TraceTables,
    maybe_build_accel,
    render_block,
    resolve_backend,
    sample_sum,
)
from pyrenderer_tpu_torch.scene.types import Camera, Scene
from pyrenderer_tpu_torch.utils.profiling import span

# pixels per rendered chunk of train_step and of the sharded renders,
# render_image's default
CHUNK = 1 << 16


# ---------------------------------------------------------------- the mesh


def _axis_sizes(n: int, a, b, default_a: bool):
    """Sizes (a, b) of a two-axis mesh over n ranks: by default every rank
    on axis a (default_a) or on axis b; a missing size is n // the other."""
    if a is None and b is None:
        a, b = (n, 1) if default_a else (1, n)
    elif a is None:
        a = n // b
    elif b is None:
        b = n // a
    if a * b != n:
        raise ValueError(f"the mesh's axes must multiply to the world size ({a}*{b} != {n})")
    return a, b


def _world_mesh(n_devices, a, b, names, default_a: bool) -> DeviceMesh:
    """A two-axis DeviceMesh over the whole world, rank-major, of sizes
    (a, b) (_axis_sizes). One rank is one device. The mesh only names the
    ranks and their groups; its device type is "cuda" under NCCL and
    "cpu" under gloo, whose ranks may still render on the card."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is up "
                           "(dist.multihost.initialize brings one up)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans the world of {n} ranks, not {n_devices}")
    shape = _axis_sizes(n, a, b, default_a)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None) -> DeviceMesh:
    """The ("dp", "sp") mesh over the world (by default every rank on dp).
    n_devices, when given, must be the world size: one rank per device.
    Raises when no process group is up."""
    return _world_mesh(n_devices, dp, sp, ("dp", "sp"), default_a=True)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on the mesh axis `name` (jax.lax.axis_index)."""
    return mesh.get_local_rank(name)


def dp_block(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous 1/dp block of n pixels (PartitionSpec("dp"))."""
    dp = axis_size(mesh, "dp")
    if n % dp:
        raise ValueError(f"{n} pixels do not divide over dp = {dp}")
    m = n // dp
    i = axis_index(mesh, "dp")
    return slice(i * m, (i + 1) * m)


# ---------------------------------------------------------- the collectives


def all_reduce(x, group=None):
    """Sum of x over the ranks of `group` (the world when None); no
    autograd. gloo takes CUDA tensors as NCCL does (checked with torch 2.11
    on an H100), so ranks that share a card pass theirs directly."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather(x, group=None):
    """(G, *x.shape): x of every rank of `group`, in rank order; no autograd."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


class _PSum(torch.autograd.Function):
    """all-reduce SUM over `group`, differentiable.

    The gradient depends on how the ranks' losses are counted, which the
    collective cannot see (torch.distributed.nn.functional.all_reduce
    always all-reduces the cotangent):
    - sum_grads=True: each rank's loss holds its own terms, every term on
      exactly one rank (the total loss is their sum). Then every summand's
      gradient is the sum of all ranks' cotangents: the backward
      all-reduces them (JAX's psum transpose). Used for the face rows of
      the triangle-sharded render, where a row's owner must receive the
      cotangents of the ranks that differentiate the pixels it shaded.
    - sum_grads=False: every rank of the group differentiates the same
      loss, a copy. Then each summand's gradient is the copy's cotangent,
      unchanged; all-reducing it would count the loss once per rank. Used
      for the sample sums over "sp"."""

    @staticmethod
    def forward(ctx, x, group, sum_grads):
        ctx.group, ctx.sum_grads = group, sum_grads
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g, ctx.group) if ctx.sum_grads else g), None, None


def psum(x, group, sum_grads: bool):
    """Differentiable sum of x over `group`; see _PSum for `sum_grads`."""
    return _PSum.apply(x, group, sum_grads)


def gather_dp(block, mesh: DeviceMesh):
    """The full (N, ...) field from every rank's dp block (an all-gather
    over "dp"; the sp ranks of a block hold the same block); no autograd."""
    return all_gather(block, mesh.get_group("dp")).flatten(0, 1)


# ------------------------------------------------------------ the renders


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
    return render_block(scene, camera, cfg, cfg.seed, cfg.spp, pixel_x, pixel_y, tables=tables)


def _mesh_tables(scene: Scene, cfg: RenderConfig, accel):
    """The tables of a dp x sp rank: the backend rule of the JAX package
    (pyrenderer_tpu/dist/render.py:74-79), "cluster_binned" traced as
    "cluster" inside the mesh; as in render_field, TraceTables applies
    PYRENDERER_CLUSTER_IMPL=binned again. A given accel is every rank's."""
    backend = resolve_backend("auto", scene.faces.shape[0], scene.vertices.device, accel)
    if backend == "cluster_binned":
        backend = "cluster"
    return TraceTables(scene, cfg, backend, accel=accel)


def _sharded_chunk(scene, camera, cfg, mesh, tables, pixel_x, pixel_y):
    """Mean radiance of one chunk of this rank's dp block: the rank's
    cfg.spp / sp samples (global sample ids sp_idx * local_spp + s), summed
    over "sp". Every sp rank returns the same chunk, a copy of one loss
    term per pixel, so the sum's backward passes each rank's cotangent to
    its own samples unchanged (psum with sum_grads=False)."""
    sp = axis_size(mesh, "sp")
    local_spp = cfg.spp // sp
    first = axis_index(mesh, "sp") * local_spp
    local = sample_sum(scene, camera, cfg, cfg.seed, tables, range(first, first + local_spp),
                       pixel_x, pixel_y)
    return psum(local, mesh.get_group("sp"), sum_grads=False) / cfg.spp


def _check_spp(cfg: RenderConfig, mesh: DeviceMesh):
    sp = axis_size(mesh, "sp")
    if cfg.spp % sp:
        raise ValueError(f"spp = {cfg.spp} does not divide over sp = {sp}")


def render_field_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: DeviceMesh,
                         pixel_x, pixel_y, accel=None):
    """This rank's (N/dp, 3) block of the mean radiance of the N given
    pixels, sharded over the ("dp", "sp") mesh: the rank's dp coordinate
    takes its contiguous block of the pixels, its sp coordinate a 1/sp
    share of the samples, rendered CHUNK pixels at a time and summed over
    "sp". gather_dp assembles the full (N, 3). Every rank calls it with
    the same arguments (the same pixels, the whole scene): the ranks issue
    the same collectives in the same order, one per chunk.

    `accel`: an accelerator every rank uses as it is (replicated), as in
    render_field; without one each rank builds the one its backend needs.
    The block is differentiable when every sp rank differentiates the same
    loss of it and the parameter gradients are then summed over the world
    (what train_step does)."""
    _check_spp(cfg, mesh)
    block = dp_block(mesh, pixel_x.shape[0])
    px, py = pixel_x[block], pixel_y[block]
    tables = _mesh_tables(scene, cfg, accel)
    return torch.cat([
        _sharded_chunk(scene, camera, cfg, mesh, tables, px[s:s + CHUNK], py[s:s + CHUNK])
        for s in range(0, px.shape[0], CHUNK)])


def loss_and_grads(params: Tuple, scene: Scene, camera: Camera, cfg: RenderConfig, target,
                   pixel_x, pixel_y, accel=None, mesh: DeviceMesh | None = None,
                   wrt=(True, True, True)):
    """The mean squared error of render_field (render_field_sharded with a
    mesh) against `target` (N, 3), and its gradients w.r.t. params =
    (vertices, albedo, emission), which replace the scene's: (loss, grads)
    with grads[i] None where not wrt[i].

    The pixels are rendered CHUNK at a time, as render_image renders
    them, and each chunk's share of the loss is differentiated before the
    next is rendered, so the autograd graph holds one chunk at most; the
    gradients are summed over the chunks. With a mesh, each rank renders
    and differentiates the chunks of its dp block; the loss is summed over
    "dp" (the sp ranks hold copies) and the gradients over the world, so
    every rank returns the same loss and gradients, those of the whole
    image. accel: as train_step's."""
    leaves = [p.detach().requires_grad_(w) for p, w in zip(params, wrt)]
    vertices, albedo, emission = leaves
    s = scene._replace(vertices=vertices, albedo=albedo, emission=emission)
    accel = maybe_build_accel(s, "auto", accel)
    trained = [i for i, w in enumerate(wrt) if w]
    grads = [torch.zeros_like(leaves[i]) for i in trained]
    loss = torch.zeros((), dtype=target.dtype, device=target.device)
    if mesh is None:
        block = slice(0, pixel_x.shape[0])
    else:
        _check_spp(cfg, mesh)
        block = dp_block(mesh, pixel_x.shape[0])
    for start in range(block.start, block.stop, CHUNK):
        sl = slice(start, min(start + CHUNK, block.stop))
        with span("forward"), torch.enable_grad():
            if mesh is None:
                img = render_field(s, camera, cfg, pixel_x[sl], pixel_y[sl], accel=accel)
            else:
                # tables per chunk, as render_field's: each chunk's graph
                # is freed by its backward
                img = _sharded_chunk(s, camera, cfg, mesh, _mesh_tables(s, cfg, accel),
                                     pixel_x[sl], pixel_y[sl])
            part = torch.sum((img - target[sl]) ** 2) / target.numel()
        loss = loss + part.detach()
        if trained:
            with span("backward"):
                for g, d in zip(grads, torch.autograd.grad(
                        part, [leaves[i] for i in trained], allow_unused=True,
                        materialize_grads=True)):
                    g += d
    if mesh is not None:
        loss = all_reduce(loss, mesh.get_group("dp"))
        grads = [all_reduce(g) for g in grads]
    out = [None, None, None]
    for i, g in zip(trained, grads):
        out[i] = g
    return loss, out


def sgd(params: Tuple, grads, lr):
    """params - lr * grads; lr a scalar or one per parameter. A parameter
    with lr 0 comes back as the same tensor (p - 0 * g would be NaN where g
    is inf), and its gradient may be None."""
    with span("sgd"):
        lrs = tuple(lr) if isinstance(lr, (tuple, list)) else (lr, lr, lr)
        return tuple(p if step == 0 else (p - step * g).detach()
                     for p, g, step in zip(params, grads, lrs))


def train_step(params: Tuple, scene: Scene, camera: Camera, cfg: RenderConfig, target,
               pixel_x, pixel_y, lr, accel=None, mesh: DeviceMesh | None = None):
    """One inverse-rendering step: render_field -> mean squared error
    against `target` (N, 3) -> one SGD step on (vertices, albedo, emission).

    params: (vertices, albedo, emission), replacing the scene's. lr: a
    scalar, or (lr_vertices, lr_albedo, lr_emission) to give each its own
    step; 0 freezes a parameter, which takes no gradient and comes back as
    the same tensor.
    accel: an accelerator for large scenes (core.integrator
    .maybe_build_accel; built here once when the scene needs one and none
    is given), passed through unchanged. The hit selection is detached, so
    an accel built from the current vertices stays a valid traversal oracle
    for the small vertex moves of a training step.
    mesh: a ("dp", "sp") mesh (make_mesh) renders the image sharded
    (render_field_sharded); every rank passes the whole target and pixels
    and ends with the same new params, those of the one-process step.
    Chunks and gradients as loss_and_grads. Returns (loss, new_params),
    detached."""
    with span("step"):
        lrs = tuple(lr) if isinstance(lr, (tuple, list)) else (lr, lr, lr)
        loss, grads = loss_and_grads(params, scene, camera, cfg, target, pixel_x, pixel_y,
                                     accel=accel, mesh=mesh, wrt=[step != 0 for step in lrs])
        return loss, sgd(params, grads, lrs)
