"""Geometry sharding: the triangles split over a "gp" mesh axis.

Counterpart of pyrenderer_tpu/dist/geometry.py. This is the scene-size
axis: rays stay put, each rank holds only its shard of the triangles (and,
for large scenes, only its shard's ClusterScene), and the global closest hit
is a reduction over the ranks of "gp". Pixels split over "dp" at the same
time: the mesh is ("dp", "gp").

Per query, in every rank of a gp group (they all trace the same rays):
  1. the closest hit against the rank's shard: the whole-table kernels
     (kernels/intersect.py, B1/B2) on its (9, T/gp) table, or the cluster
     sweep (kernels/cluster.py, B3/B4) on its own ClusterScene; on the CPU
     their plain twins;
  2. each rank's masked t is all-gathered over "gp" and arg-minned: the
     first minimum is the lowest rank, which holds the lowest face ids, so
     a tie goes to the lowest face as in the un-sharded query;
  3. the winner's global face id (its local id + the shard's base) by an
     int32 all-reduce SUM, every other rank sending 0;
  4. shadow rays by an int32 all-reduce of the occlusion flags;
  5. the packed face rows by an all-reduce SUM of the rows masked to the
     owner, differentiable (dist/render.psum with sum_grads=True): the
     cotangents of every rank reach the owner's rows, and from there the
     (vertices, albedo, emission) the shards were packed from.

Every gp rank computes the same (N/dp, 3) block and returns its 1/gp slice
of the rows (the JAX package's out_specs P(("dp", "gp"))), so each pixel's
loss term is differentiated on exactly one rank: the condition under which
the face rows' summed cotangents are right, and under which the gradients
of the parameters every rank holds (the light rows, the scene) are summed
over the world once.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from pyrenderer_tpu_torch.accel.clusters import ClusterScene, build_clusters
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.integrator import (
    TraceTables,
    pack_face_data,
    pack_light_data,
    render_sample,
    resolve_cluster_sort,
    resolve_cluster_watertight,
)
from pyrenderer_tpu_torch.dist.render import (
    CHUNK,
    _world_mesh,
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
    dp_block,
    psum,
    sgd,
)
from pyrenderer_tpu_torch.kernels import cluster as cluster_kernels
from pyrenderer_tpu_torch.kernels import intersect as kernels
from pyrenderer_tpu_torch.scene.types import Camera, Scene


def make_geom_mesh(n_devices: int | None = None, gp: int | None = None,
                   dp: int | None = None) -> DeviceMesh:
    """The ("dp", "gp") mesh over the world: pixel blocks x triangle shards
    (by default every rank on gp). n_devices, when given, must be the world
    size."""
    return _world_mesh(n_devices, dp, gp, ("dp", "gp"), default_a=False)


def _pad_to(x, rows):
    pad = rows - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def shard_geometry(scene: Scene, cfg: RenderConfig, gp: int):
    """(gp, T_local, ...) stacks of the triangles and of the packed face
    rows, T_local = ceil(T / gp), and the light rows every rank holds.

    Padding rows are zero: e1 = e2 = 0 makes the Moeller-Trumbore det 0,
    which the accept test rejects, so a pad can never win a hit.
    Returns ((v0, e1, e2), face_data, light_data). The triangles are
    detached (the hit selection is); the gradients ride the face rows."""
    extended = cfg.estimator != "reference"
    face_data = pack_face_data(scene, extended=extended)
    light_data = pack_light_data(scene, use_emission=extended)
    v = scene.vertices.detach()
    f = scene.faces
    v0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - v0
    e2 = v[f[:, 2]] - v0
    t_local = -(-f.shape[0] // gp)

    def shard(x):
        return _pad_to(x, t_local * gp).reshape((gp, t_local) + tuple(x.shape[1:]))

    return (shard(v0), shard(e1), shard(e2)), shard(face_data), light_data


def build_shard_clusters(scene: Scene, gp: int, rank: int | None = None):
    """The ClusterScene of triangle shard `rank` (faces rank * T_local up to
    T_local of them, zero-padded to T_local: a zero face is the point
    vertex 0, det 0, and never wins), on the device of the scene's vertices.
    A rank builds and holds only its own shard's; rank=None builds all gp
    of them, as a list (the JAX package stacks them for its shard_map).
    Face ids in a shard's ClusterScene are local to the shard."""
    v = scene.vertices
    device = v.device if torch.is_tensor(v) else torch.device("cpu")
    v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    f = scene.faces.cpu().numpy() if torch.is_tensor(scene.faces) else np.asarray(scene.faces)
    t_local = -(-f.shape[0] // gp)

    def one(g):
        fl = f[g * t_local:(g + 1) * t_local]
        pad = t_local - fl.shape[0]
        if pad:
            fl = np.concatenate([fl, np.zeros((pad, 3), f.dtype)])
        return build_clusters(v, fl).to(device)

    return one(rank) if rank is not None else [one(g) for g in range(gp)]


def _strip_scene(scene: Scene) -> Scene:
    """The scene without its triangles: every geometry access of the
    sharded render goes through the custom tables, so a rank keeps only
    the light and material rows the integrator reads from `scene`."""
    v = scene.vertices
    return scene._replace(
        vertices=v.new_zeros((1, 3)),
        faces=scene.faces.new_zeros((1, 3)),
        normal_sign=scene.normal_sign.new_zeros((1,)),
        face_material=scene.face_material.new_zeros((1,)),
    )


def _shard_tables(scene: Scene, cfg: RenderConfig, mesh: DeviceMesh, cluster_stack):
    """TraceTables.custom of this rank's shard: the local query (step 1 of
    the module docstring) and the combines over "gp" (steps 2-5)."""
    gp = axis_size(mesh, "gp")
    g = axis_index(mesh, "gp")
    group = mesh.get_group("gp")
    (v0s, e1s, e2s), face_shards, light_data = shard_geometry(scene, cfg, gp)
    t_local = face_shards.shape[1]
    fdl = face_shards[g]
    base = g * t_local

    if cluster_stack is not None:
        cs = cluster_stack if isinstance(cluster_stack, ClusterScene) else cluster_stack[g]
        # the sort and the leaves are resolved per shard, as the JAX package
        # does (geometry.py:229-230): a shard below AUTO_SORT_MIN_CLUSTERS
        # clusters takes Moeller-Trumbore leaves where the whole scene
        # would take watertight ones
        sort = resolve_cluster_sort(cfg, cs)
        watertight = resolve_cluster_watertight(cfg, cs)

        def local_closest(ro, rd, t1):
            # exact_t=False: the t the kernel compares, so that the combine
            # picks the winner the un-sharded sweep picks (up to ties)
            return cluster_kernels.closest_hit(
                cs, ro, rd, cfg.t_min, t1, sort=sort, watertight=watertight, exact_t=False,
                rounds=cfg.cluster_rounds, budget=cfg.cluster_budget)

        def local_occluded(ro, rd, t1):
            return cluster_kernels.occluded(cs, ro, rd, cfg.t_min, t1, sort=sort,
                                            watertight=watertight)
    else:
        # the shard's (9, T_local) table for B1/B2 (float32 on the card;
        # the twins on the CPU keep the scene's dtype); the JAX package
        # runs its plain jnp test here
        table = torch.cat([v0s[g].T, e1s[g].T, e2s[g].T]).contiguous()

        def local_closest(ro, rd, t1):
            return kernels.closest_hit(table, ro, rd, cfg.t_min, t1)

        def local_occluded(ro, rd, t1):
            return kernels.occluded(table, ro, rd, cfg.t_min, t1)

    def closest(ro, rd, t1):
        hit_l, t_l, tri_l = local_closest(ro, rd, t1)
        t_m = torch.where(hit_l, t_l.to(ro.dtype), math.inf)
        t_all = all_gather(t_m, group)                     # (gp, N)
        t_min = t_all.min(dim=0).values
        winner = torch.argmin(t_all, dim=0)                # first minimum
        # B1 gives tri = -1 on a miss (the twins and the sweep 0): masked by
        # hit before the base is added
        mine = (winner == g) & hit_l
        tri_g = all_reduce(torch.where(mine, tri_l.to(torch.int32) + base, 0).to(torch.int32),
                           group)
        hit_g = torch.isfinite(t_min)
        return hit_g, torch.where(hit_g, t_min, 0.0), tri_g

    def any_hit(ro, rd, t1):
        return all_reduce(local_occluded(ro, rd, t1).to(torch.int32), group) > 0

    def fetch_face(tri):
        mine = (tri >= base) & (tri < base + t_local)
        row = fdl.index_select(0, torch.clamp(tri - base, 0, t_local - 1))
        return psum(torch.where(mine[:, None], row, 0.0), group, sum_grads=True)

    return TraceTables.custom(fdl, light_data, closest, any_hit, fetch_face)


def _check_pixels(mesh: DeviceMesh, n: int):
    dp, gp = axis_size(mesh, "dp"), axis_size(mesh, "gp")
    if n % (dp * gp):
        raise ValueError(f"{n} pixels do not divide over dp*gp = {dp * gp}")


def _block_chunks(scene, camera, cfg, mesh, cluster_stack, px, py):
    """Mean radiance of a pixel block, CHUNK pixels at a time: yields
    (start, the chunk's (n, 3) radiance). Each chunk packs its own shard
    tables, so that a chunk's backward frees what it built."""
    scene_l = _strip_scene(scene)
    for start in range(0, px.shape[0], CHUNK):
        x, y = px[start:start + CHUNK], py[start:start + CHUNK]
        tables = _shard_tables(scene, cfg, mesh, cluster_stack)
        total = None
        for s in range(cfg.spp):
            r = render_sample(scene_l, camera, cfg, cfg.seed, s, x, y, tables=tables)
            total = r if total is None else total + r
        yield start, total / cfg.spp


def render_field_geometry_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                                  mesh: DeviceMesh, pixel_x, pixel_y, cluster_stack=None):
    """This rank's (N/(dp*gp), 3) slice of the mean radiance of the N given
    pixels with the triangles sharded over "gp" and the pixels over "dp":
    the gp-th slice of the rank's dp block (dp-major, as the JAX package's
    P(("dp", "gp"))); all_gather over the world, in rank order, assembles
    the (N, 3) field. The same function as the un-sharded render: the min
    and argmin combine and the masked sums are exact.

    cluster_stack: None traces each shard with B1/B2 (their twins on the
    CPU); else this rank's ClusterScene (build_shard_clusters(scene, gp,
    rank=its gp coordinate)) or all gp of them, which the sweep traverses.
    Every rank calls it with the same arguments."""
    _check_pixels(mesh, pixel_x.shape[0])
    block = dp_block(mesh, pixel_x.shape[0])
    out = torch.cat([r for _, r in _block_chunks(scene, camera, cfg, mesh, cluster_stack,
                                                 pixel_x[block], pixel_y[block])])
    q = out.shape[0] // axis_size(mesh, "gp")
    g = axis_index(mesh, "gp")
    return out[g * q:(g + 1) * q]


def train_step_geometry(params, scene: Scene, camera: Camera, cfg: RenderConfig,
                        mesh: DeviceMesh, target, pixel_x, pixel_y, lr, cluster_stack=None):
    """One inverse-rendering step (the mean squared error against `target`
    (N, 3), one SGD step on params = (vertices, albedo, emission)) with the
    triangles sharded over "gp" and the pixels over "dp". Every rank passes
    the whole target and pixels and ends with the same new params, those
    of the one-process step.

    Each rank differentiates the loss terms of its own slice of the pixels
    (render_field_geometry_sharded's), CHUNK pixels of its dp block at a
    time, so that the face rows' gradients reach their owners once; the
    loss and the gradients are then summed over the world. Every rank runs
    backward on every chunk, slice or no slice: the face rows' backward is
    a collective. cluster_stack as render_field_geometry_sharded's (a fixed
    accel stays a valid traversal oracle for the small vertex moves of a
    step: the hit selection is detached). lr as dist.render.train_step's.
    Returns (loss, new_params), detached."""
    lrs = tuple(lr) if isinstance(lr, (tuple, list)) else (lr, lr, lr)
    leaves = [p.detach().requires_grad_(step != 0) for p, step in zip(params, lrs)]
    vertices, albedo, emission = leaves
    s = scene._replace(vertices=vertices, albedo=albedo, emission=emission)
    trained = [i for i, step in enumerate(lrs) if step != 0]
    grads = [torch.zeros_like(leaves[i]) for i in trained]
    loss = torch.zeros((), dtype=target.dtype, device=target.device)
    _check_pixels(mesh, pixel_x.shape[0])
    block = dp_block(mesh, pixel_x.shape[0])
    q = (block.stop - block.start) // axis_size(mesh, "gp")
    own = block.start + axis_index(mesh, "gp") * q       # this rank's slice: [own, own + q)
    with torch.enable_grad():
        for start, img in _block_chunks(s, camera, cfg, mesh, cluster_stack,
                                        pixel_x[block], pixel_y[block]):
            c0 = block.start + start
            lo = max(own, c0)
            hi = max(lo, min(own + q, c0 + img.shape[0]))  # lo == hi: none owned here
            part = torch.sum((img[lo - c0:hi - c0] - target[lo:hi]) ** 2) / target.numel()
            loss = loss + part.detach()
            if trained:
                for acc, d in zip(grads, torch.autograd.grad(
                        part, [leaves[i] for i in trained], allow_unused=True,
                        materialize_grads=True)):
                    acc += d
    loss = all_reduce(loss)
    grads = [all_reduce(g) for g in grads]
    full = [None, None, None]
    for i, g in zip(trained, grads):
        full[i] = g
    return loss, sgd(params, full, lrs)
