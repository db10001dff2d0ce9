"""Component microbenchmarks of the wavefront on the Cornell box: each stage
of a bounce at one ray count, to find where its time goes.

Counterpart of perf/microbench.py, on its inputs (MB_N = 2^20 rays from
numpy RandomState(0): origins in the box, unit directions):

  cuda_closest, cuda_occluded
                 the whole-table kernels B1 and B2 (csrc/intersect.cu; the
                 JAX rows pallas_closest and pallas_occluded)
  packed_gather16
                 one (T, 16) packed face-row gather per ray
  intersect_matmul, intersect_brute, occluded_matmul
                 core/intersect.py's plain-PyTorch queries (the matmul ones
                 IEEE float32 under core/intersect._ieee_fp32)
  rng_8draws     eight Threefry uniforms
  frame_math     the cosine sample rotated into a normal's frame
  vertex_gather  three vertex gathers through the face table
  trace_4bounce_{backend}
                 trace_reference, 4 bounces (MB_BACKEND, default "auto":
                 "cuda" on the card, where the bounce is the kernels of
                 csrc/reference.cu), its rays counted into a RenderStats
                 for Mrays/s
  camera_raygen  generate_rays for one wavefront

Env knobs, as in the JAX harness: MB_N (rays), MB_ONLY (comma-separated
prefixes of the rows to run), MB_BACKEND. ``--n`` overrides MB_N. Timing is
utils/profiling.slope_time (eager ms, graph ms for CAPTURABLE, and of one
call the device's busy ms, its device events, host syncs and kernel
launches) where the JAX harness averaged 20 calls;
the tables of the trace row are built once, outside the timed calls.

    python -m pyrenderer_tpu_torch.perf.microbench [--n N] [--reps R] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.perf import harness
from pyrenderer_tpu_torch.perf.estbench import SCENE

N = 1 << 20

# the rows a CUDA graph can capture: all but frame_math and the trace, which
# rotate into a shading frame (perf/estbench.py's docstring says why that
# cannot be captured)
CAPTURABLE = ("cuda_closest", "cuda_occluded", "packed_gather16", "intersect_matmul",
              "intersect_brute", "occluded_matmul", "rng_8draws", "vertex_gather",
              "camera_raygen")


def host_inputs(n=N):
    """The JAX harness's arrays from RandomState(0) in its order: ro in the
    box (float32), rd (float32, normalised in float32), then the camera
    row's px, py (int32, < 1024)."""
    rs = np.random.RandomState(0)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32) + np.float32([0, 1, 0])
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    px = rs.randint(0, 1024, n).astype(np.int32)
    py = rs.randint(0, 1024, n).astype(np.int32)
    return dict(ro=ro, rd=rd, px=px, py=py)


def inputs(device, n=N, backend=None):
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core import intersect as isect
    from pyrenderer_tpu_torch.core.integrator import TraceTables, pack_face_data
    from pyrenderer_tpu_torch.kernels import intersect as ki
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device

    host, camera, _ = load_tungsten(SCENE)
    scene, camera = to_device(host, camera, device)
    h = host_inputs(n)
    n_tris = scene.faces.shape[0]
    cfg = RenderConfig(max_bounces=4, spp=1, seed=0)
    backend = os.environ.get("MB_BACKEND", "auto") if backend is None else backend
    tables = TraceTables(scene, cfg, backend)
    pid = torch.arange(n, dtype=torch.int64, device=device)
    return types.SimpleNamespace(
        scene=scene, camera=camera, cfg=cfg, tables=tables, backend=backend, host=h,
        ro=torch.as_tensor(h["ro"], device=device), rd=torch.as_tensor(h["rd"], device=device),
        px=torch.as_tensor(h["px"].astype(np.int64), device=device),
        py=torch.as_tensor(h["py"].astype(np.int64), device=device),
        pid=pid, tri=pid % n_tris, face_data=pack_face_data(scene),
        tri_table=ki.pack_triangles(scene.vertices, scene.faces),
        tri_matrix=isect.build_tri_matrix(scene),
        t2=torch.full((n,), 2.0, device=device))


def cuda_closest(tri_table, ro, rd):
    from pyrenderer_tpu_torch.kernels import intersect as ki

    return ki.closest_hit(tri_table, ro, rd, 1e-5, 1e5)


def cuda_occluded(tri_table, ro, rd, t1):
    from pyrenderer_tpu_torch.kernels import intersect as ki

    return ki.occluded(tri_table, ro, rd, 1e-5, t1)


def packed_gather16(face_data, tri):
    return face_data[tri]


def intersect_matmul(scene, tri_matrix, ro, rd):
    from pyrenderer_tpu_torch.core import intersect as isect

    with isect._ieee_fp32():
        return isect.intersect_matmul(scene, ro, rd, 1e-5, 1e5, tri_matrix)


def intersect_brute(scene, ro, rd):
    from pyrenderer_tpu_torch.core import intersect as isect

    return isect.intersect_brute(scene, ro, rd, 1e-5, 1e5)


def occluded_matmul(scene, tri_matrix, ro, rd, t1):
    from pyrenderer_tpu_torch.core import intersect as isect

    with isect._ieee_fp32():
        return isect.occluded_matmul(scene, ro, rd, 1e-5, t1, tri_matrix)


def rng_8draws(pid):
    return sum(rng.uniform(0, pid, 0, 1, u) for u in range(8))


def frame_uniforms(pid):
    """frame_math's (u1, u2): the JAX harness's uniform(0, pid, 0, 0, 0|1)."""
    return rng.uniform(0, pid, 0, 0, 0), rng.uniform(0, pid, 0, 0, 1)


def frame_math(rd, u1, u2):
    from pyrenderer_tpu_torch.core import sampling

    return sampling.rotate_z_to(-rd, sampling.cosine_sample_hemisphere(u1, u2))


def vertex_gather(scene, tri):
    f = scene.faces[tri]
    return scene.vertices[f[:, 0]] + scene.vertices[f[:, 1]] + scene.vertices[f[:, 2]]


def trace_4bounce(scene, cfg, tables, ro, rd, pid):
    """(radiance, rays traced) of one 4-bounce wavefront, with_stats."""
    from pyrenderer_tpu_torch.core.integrator import trace_reference

    return trace_reference(scene, cfg, ro, rd, pid, pid * 0, 0, tables=tables,
                           with_stats=True)


def camera_raygen(camera, px, py):
    from pyrenderer_tpu_torch.core.camera import generate_rays

    return generate_rays(camera, px, py, px * 0, 0)


def stages(x):
    """(name, fn, args) of every row, in the JAX harness's order."""
    u1, u2 = frame_uniforms(x.pid)
    return [
        ("cuda_closest", cuda_closest, (x.tri_table, x.ro, x.rd)),
        ("cuda_occluded", cuda_occluded, (x.tri_table, x.ro, x.rd, x.t2)),
        ("packed_gather16", packed_gather16, (x.face_data, x.tri)),
        ("intersect_matmul", intersect_matmul, (x.scene, x.tri_matrix, x.ro, x.rd)),
        ("intersect_brute", intersect_brute, (x.scene, x.ro, x.rd)),
        ("occluded_matmul", occluded_matmul, (x.scene, x.tri_matrix, x.ro, x.rd, x.t2)),
        ("rng_8draws", rng_8draws, (x.pid,)),
        ("frame_math", frame_math, (x.rd, u1, u2)),
        ("vertex_gather", vertex_gather, (x.scene, x.tri)),
        (f"trace_4bounce_{x.tables.backend}", trace_4bounce,
         (x.scene, x.cfg, x.tables, x.ro, x.rd, x.pid)),
        ("camera_raygen", camera_raygen, (x.camera, x.px, x.py)),
    ]


def run(device, args):
    from pyrenderer_tpu_torch.utils.profiling import RenderStats, slope_time

    n = args.n if args.n is not None else int(os.environ.get("MB_N", str(N)))
    only = os.environ.get("MB_ONLY")
    only = only.split(",") if only else None
    x = inputs(device, n)
    report = harness.Report("microbench", device, n, reps=args.reps, backend=x.tables.backend)
    for name, fn, fn_args in stages(x):
        # MB_ONLY's prefixes as the JAX harness reads them ("pallas" for its
        # whole-table rows, "trace", "rng", "frame", ...)
        key = name.replace("cuda_", "pallas_")
        if only is not None and not any(key.startswith(o) or name.startswith(o) for o in only):
            continue
        st = slope_time(fn, *fn_args, reps=args.reps, graph=name in CAPTURABLE,
                        profile=not args.no_profile)
        # a slope at or below 0 (host noise on a tiny stage) gives no rate
        rate = st.eager_ms > 0
        extra = {"mitems_per_s": n / (st.eager_ms * 1e-3) / 1e6 if rate else None}
        if name.startswith("trace_4bounce") and rate:
            stats = RenderStats()
            stats.add(float(st.out[1]), 1, n, st.eager_ms * 1e-3)
            extra["mrays_per_s"] = stats.mrays_per_sec
            extra["summary"] = stats.summary()
        report.row(name, st, **extra)
    return report.result()


def main(argv=None) -> int:
    p = harness.parser(__doc__.split("\n\n")[0], N)
    p.set_defaults(n=None)
    args = p.parse_args(argv)
    return harness.main(run, args)


if __name__ == "__main__":
    sys.exit(main())
