"""Ablation of the reference bounce loop on the Cornell box: stripped
variants built from the loop's own pieces, to split a bounce's time.

Counterpart of perf/ablate.py, on its inputs (n = 2^20 rays from numpy
RandomState(0), perf/microbench.py's):

  full_4bounce    trace_reference, 4 bounces (backend "auto": the
                  whole-table kernels on the card)
  isect_only_4x2  4 x (the closest hit, then the any hit to it) on a
                  carried ray: the integrator's _closest and _any_hit, 4
                  launches each of B1 and B2
  fetch_only_4x   4 x (a packed face-row fetch and a light-point sample)
  rng_frame_4x    4 x (a uniform2 draw and the cosine sample rotated into
                  the ray's frame)

Timing is utils/profiling.slope_time (eager ms, graph ms for CAPTURABLE,
and of one call the device's busy ms, its device events, host syncs and
kernel launches), where the JAX harness averaged 10 calls between two host
syncs.

    python -m pyrenderer_tpu_torch.perf.ablate [--n N] [--reps R] [--device cpu]
"""

from __future__ import annotations

import sys
import types

import torch

from pyrenderer_tpu_torch import rng
from pyrenderer_tpu_torch.perf import harness
from pyrenderer_tpu_torch.perf.estbench import SCENE
from pyrenderer_tpu_torch.perf.microbench import host_inputs

N = 1 << 20
# full_4bounce and rng_frame_4x rotate into a shading frame, which a CUDA
# graph cannot capture (perf/estbench.py's docstring says why)
CAPTURABLE = ("isect_only_4x2", "fetch_only_4x")


def inputs(device, n=N):
    from pyrenderer_tpu_torch.config import RenderConfig
    from pyrenderer_tpu_torch.core.integrator import TraceTables
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device

    host, camera, _ = load_tungsten(SCENE)
    scene, _ = to_device(host, camera, device)
    cfg = RenderConfig(max_bounces=4, seed=0)
    h = host_inputs(n)
    return types.SimpleNamespace(
        scene=scene, cfg=cfg, tables=TraceTables(scene, cfg, "auto"), host=h,
        ro=torch.as_tensor(h["ro"], device=device), rd=torch.as_tensor(h["rd"], device=device),
        pid=torch.arange(n, dtype=torch.int64, device=device))


def full_4bounce(scene, cfg, tables, ro, rd, pid):
    from pyrenderer_tpu_torch.core.integrator import trace_reference

    return trace_reference(scene, cfg, ro, rd, pid, pid * 0, 0, tables=tables)


def isect_only(scene, cfg, tables, ro, rd):
    """4 x (closest hit, any hit up to it); the ray moves half way to the hit
    and turns back where the any hit found an occluder."""
    from pyrenderer_tpu_torch.core.integrator import _any_hit, _closest

    for _ in range(4):
        _, t, _ = _closest(scene, tables, cfg, ro, rd, cfg.t_max)
        occ = _any_hit(scene, tables, cfg, ro, rd, t)
        ro = ro + t[:, None] * rd * 0.5
        rd = torch.where(occ[:, None], -rd, rd)
    return ro


def fetch_only(scene, tables, ro, pid):
    """4 x (face row of face (pid + b) mod T, light point of bounce b)."""
    from pyrenderer_tpu_torch.core.integrator import _sample_light_point

    acc = ro * 0
    n_tris = scene.faces.shape[0]
    for b in range(4):
        row = tables.fetch_face((pid + b) % n_tris)
        p2, n2, em, _ = _sample_light_point(scene, tables, pid, pid * 0, b, 0, torch.float32)
        acc = acc + row[:, 0:3] + p2 * n2 * em
    return acc


def rng_frame(ro, rd, pid):
    """4 x (uniform2, cosine sample in the frame of -rd); the ray steps along
    the sample."""
    from pyrenderer_tpu_torch.core import sampling

    for b in range(4):
        u1, u2 = rng.uniform2(0, pid, pid * 0, b, rng.U_BSDF_0)
        wi = sampling.rotate_z_to(-rd, sampling.cosine_sample_hemisphere(u1, u2))
        ro, rd = ro + wi * 0.01, wi
    return ro


def stages(x):
    return [
        ("full_4bounce", full_4bounce, (x.scene, x.cfg, x.tables, x.ro, x.rd, x.pid)),
        ("isect_only_4x2", isect_only, (x.scene, x.cfg, x.tables, x.ro, x.rd)),
        ("fetch_only_4x", fetch_only, (x.scene, x.tables, x.ro, x.pid)),
        ("rng_frame_4x", rng_frame, (x.ro, x.rd, x.pid)),
    ]


def run(device, args):
    from pyrenderer_tpu_torch.utils.profiling import slope_time

    x = inputs(device, args.n)
    report = harness.Report("ablate", device, args.n, reps=args.reps, backend=x.tables.backend)
    for name, fn, fn_args in stages(x):
        report.row(name, slope_time(fn, *fn_args, reps=args.reps, graph=name in CAPTURABLE,
                                    profile=not args.no_profile))
    return report.result()


def main(argv=None) -> int:
    args = harness.parser(__doc__.split("\n\n")[0], N).parse_args(argv)
    return harness.main(run, args)


if __name__ == "__main__":
    sys.exit(main())
