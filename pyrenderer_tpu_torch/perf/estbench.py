"""Slope-timed breakdown of the estimator's arithmetic on the Cornell box:
the part of a frame outside the intersection kernels, stage by stage.

Counterpart of perf/estbench.py, on the same inputs (N = 262,144 rays from
numpy.random.default_rng(0), seed 3, the 36-triangle Cornell box):

  rng1/rng2     one Threefry-2x32 evaluation (uniform / uniform2)
  rng_bounce    one bounce's draws of the Cornell case: uniform2 + uniform
                + uniform2, three Threefry evaluations
  fetch_face    the packed face-row fetch ((36, 16) table; index_select,
                where the JAX package fetches by core/lut.fetch_rows)
  fetch_light   the light-point sampling block (_sample_light_point)
  shade         the shading block: the hit re-derived from the face row, the
                normal, the cosine sample rotated into the frame, the
                throughput update
  camera        generate_rays for one wavefront
  trace4_full   trace_reference, 4 bounces, with the kernels (4 launches
                each of B1 and B2, csrc/intersect.cu, and on the card of
                the bounce kernels, csrc/reference.cu)
  trace4_stub   the same with both queries stubbed (TraceTables.custom):
                the estimator's arithmetic alone (on the card its bounce
                kernels)
  pbrt_trace4_full, pbrt_trace4_stub
                the same two rows for trace_pbrt
  kernel_pair   one closest-hit and one any-hit launch (B1 + B2)

Each stage is a function of this module that returns what it computes (the
JAX stages reduced theirs to a scalar, their scan's carry); the tests hold
each against its JAX counterpart on the CPU. Timing is utils/profiling.slope_time: eager ms
(the slope of back-to-back calls, what a call costs the frame, host
dispatch included), graph ms (a CUDA-graph replay: the device's own time)
for the stages in CAPTURABLE, and of one call under torch.profiler the
device's busy ms, its device events and the host's waits for the device
(syncs), beside the port's kernel launches of one call. The JAX harness's
scan carry, which kept XLA from hoisting the work out of its loop, has no
counterpart: eager calls all run.

shade and the trace rows are not captured: core/sampling._axis, three times
in each rotate_z_to (once a bounce), writes a Python float into a device
tensor, a copy from pageable host memory after which PyTorch synchronises
the stream, and which a CUDA graph refuses. This harness changes no path
that bench.py times; their device time is the profiler's busy ms, and their
syncs column counts those waits.

    python -m pyrenderer_tpu_torch.perf.estbench [--n N] [--reps R] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np
import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.perf import harness

N = 262144
SEED = 3
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENE = os.path.join(ROOT, "scenes", "cornell_box.json")

# the stages a CUDA graph can capture; the others rotate a direction into a
# shading frame (core/sampling.rotate_z_to), which copies a Python float
# into a device tensor (sampling._axis): a copy from pageable memory, which
# a capture refuses (module docstring)
CAPTURABLE = ("rng1", "rng2", "rng_bounce", "fetch_face", "fetch_light", "camera",
              "kernel_pair")


def host_inputs(n=N):
    """The JAX harness's arrays (perf/estbench.py:84-93 and the later
    draws), from numpy.random.default_rng(0) in its order: pixel (uint32),
    ro, rd (float32), tri (int32, < 36), px, py (int32, < 1024)."""
    rngs = np.random.default_rng(0)
    pixel = rngs.integers(0, 1 << 20, n).astype(np.uint32)
    ro = rngs.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    rd = rngs.standard_normal((n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    tri = rngs.integers(0, 36, n).astype(np.int32)
    px = rngs.integers(0, 1024, n).astype(np.int32)
    py = rngs.integers(0, 1024, n).astype(np.int32)
    return dict(pixel=pixel, ro=ro, rd=rd, tri=tri, px=px, py=py)


def inputs(device, n=N):
    """Everything the stages take, on `device`: the scene and camera, the
    configs and tables of both estimators (backend "cuda": the kernels on
    the card, their twins on the CPU) and the tensors of host_inputs."""
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import TraceTables
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device

    host, camera, _ = load_tungsten(SCENE)
    scene, camera = to_device(host, camera, device)
    cfg = RenderConfig(max_bounces=4, spp=1, seed=SEED)
    cfg_pbrt = cfg.replace(estimator="pbrt")
    h = host_inputs(n)
    t = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind in "iu" else v, device=device)
         for k, v in h.items()}
    return types.SimpleNamespace(
        scene=scene, camera=camera, cfg=cfg, cfg_pbrt=cfg_pbrt, host=h,
        tables=TraceTables(scene, cfg, "cuda"), tables_pbrt=TraceTables(scene, cfg_pbrt, "cuda"),
        sample=torch.zeros(n, dtype=torch.int64, device=device), **t)


def rng1(pixel, sample):
    return rng.uniform(SEED, pixel, sample, 1, rng.U_LIGHT_FACE)


def rng2(pixel, sample):
    return rng.uniform2(SEED, pixel, sample, 1, rng.U_BSDF_0)[0]


def rng_bounce(pixel, sample):
    u1, u2 = rng.uniform2(SEED, pixel, sample, 1, rng.U_BSDF_0)
    uf = rng.uniform(SEED, pixel, sample, 1, rng.U_LIGHT_FACE)
    ul, uv = rng.uniform2(SEED, pixel, sample, 1, rng.U_LIGHT_U)
    return u1, u2, uf, ul, uv


def fetch_face(face_data, tri):
    return face_data.index_select(0, tri)


def fetch_light(scene, tables, pixel, sample):
    from pyrenderer_tpu_torch.core.integrator import _sample_light_point

    return _sample_light_point(scene, tables, pixel, sample, 1, SEED, torch.float32)[:3]


def shade(face_data, tri, pixel, sample, ro, rd):
    """The JAX harness's shade: the hit re-derived from the face row, the
    geometric normal, a cosine sample rotated into its frame and the
    throughput update: (beta, hit point)."""
    from pyrenderer_tpu_torch.core import sampling
    from pyrenderer_tpu_torch.core.sampling import INV_PI

    row = face_data.index_select(0, tri)
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    albedo = row[:, 9:12]
    sign = row[:, 12]
    s = ro - v0
    det = torch.sum(torch.linalg.cross(e1, rd, dim=-1) * e2, dim=-1)
    safe_det = torch.where(det == 0, 1.0, det)
    t = -torch.sum(torch.linalg.cross(s, e2, dim=-1) * e1, dim=-1) / safe_det
    hp = ro + t[:, None] * rd
    n_geo = sign[:, None] * sampling.safe_normalize(torch.linalg.cross(e1, e2, dim=-1))
    u1, u2 = rng.uniform2(SEED, pixel, sample, 1, rng.U_BSDF_0)
    wi = sampling.rotate_z_to(n_geo, sampling.cosine_sample_hemisphere(u1, u2))
    cos_wi = torch.sum(n_geo * wi, dim=-1)
    pdf = cos_wi.abs() * INV_PI
    safe_pdf = torch.where(pdf == 0, 1.0, pdf)
    scale = sampling.maximum(cos_wi, 0.0) / safe_pdf * INV_PI
    return albedo * scale[:, None], hp


def camera_rays(camera, px, py, sample):
    from pyrenderer_tpu_torch.core.camera import generate_rays

    return generate_rays(camera, px, py, sample, SEED)


def trace4(trace, scene, cfg, tables, ro, rd, pixel, sample):
    """One 4-bounce trace of the wavefront: (N, 3) radiance."""
    return trace(scene, cfg, ro, rd, pixel, sample, SEED, tables=tables)


def stub_tables(tables, tri):
    """`tables` with both queries stubbed, as the JAX harness stubs them: a
    live lane hits face tri at t = 1, a shadow ray is blocked only when
    dead."""
    from pyrenderer_tpu_torch.core.integrator import TraceTables

    t_hit = torch.ones(tri.shape[0], dtype=tables.face_data.dtype, device=tri.device)

    def closest(ro, rd, t1):
        return t1 > 0, t_hit, tri

    def any_hit(ro, rd, t1):
        return t1 <= 0

    return TraceTables.custom(tables.face_data, tables.light_data, closest, any_hit)


def kernel_pair(tri_table, cfg, ro, rd):
    """One bounce's queries: B1 against the whole table, B2 to t = 1."""
    from pyrenderer_tpu_torch.kernels import intersect as ki

    _, t, _ = ki.closest_hit(tri_table, ro, rd, cfg.t_min, cfg.t_max)
    occ = ki.occluded(tri_table, ro, rd, cfg.t_min, 1.0)
    return t + occ.to(t.dtype)


def stages(x):
    """(name, fn, args, note) of every row, in the JAX harness's order,
    both estimators' trace rows."""
    from pyrenderer_tpu_torch.core.integrator import trace_reference
    from pyrenderer_tpu_torch.core.integrator_pbrt import trace_pbrt

    rows = [
        ("rng1", rng1, (x.pixel, x.sample), ""),
        ("rng2", rng2, (x.pixel, x.sample), ""),
        ("rng_bounce", rng_bounce, (x.pixel, x.sample), "3 Threefry evaluations"),
        ("fetch_face", fetch_face, (x.tables.face_data, x.tri), ""),
        ("fetch_light", fetch_light, (x.scene, x.tables, x.pixel, x.sample), ""),
        ("shade", shade, (x.tables.face_data, x.tri, x.pixel, x.sample, x.ro, x.rd), ""),
        ("camera", camera_rays, (x.camera, x.px, x.py, x.sample), ""),
    ]
    for prefix, trace, cfg, tables in (("", trace_reference, x.cfg, x.tables),
                                       ("pbrt_", trace_pbrt, x.cfg_pbrt, x.tables_pbrt)):
        args = (x.ro, x.rd, x.pixel, x.sample)
        rows.append((f"{prefix}trace4_full", _bind(trace4, trace, x.scene, cfg, tables), args,
                     "4 bounces incl. 8 kernel calls"))
        rows.append((f"{prefix}trace4_stub",
                     _bind(trace4, trace, x.scene, cfg, stub_tables(tables, x.tri)), args,
                     "4 bounces, intersection stubbed"))
    rows.append(("kernel_pair", kernel_pair, (x.tables.tri_table, x.cfg, x.ro, x.rd),
                 "closest + anyhit, one bounce's queries"))
    return rows


def _bind(fn, *bound):
    def call(*args):
        return fn(*bound, *args)
    return call


def run(device, args):
    from pyrenderer_tpu_torch.utils.profiling import slope_time

    x = inputs(device, args.n)
    report = harness.Report("estbench", device, args.n, reps=args.reps)
    for name, fn, fn_args, note in stages(x):
        st = slope_time(fn, *fn_args, reps=args.reps, graph=name in CAPTURABLE,
                        profile=not args.no_profile)
        report.row(name, st, note=note)
    return report.result()


def main(argv=None) -> int:
    args = harness.parser(__doc__.split("\n\n")[0], N).parse_args(argv)
    return harness.main(run, args)


if __name__ == "__main__":
    sys.exit(main())
