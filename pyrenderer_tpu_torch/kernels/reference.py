"""The reference estimator's bounce as two CUDA kernels: the wrapper.

The kernels (csrc/reference.cu) replace no TPU kernel: the JAX package's
bounce is jnp ops that XLA fuses. Eager PyTorch has no such fusion, so the
eager bounce of core/integrator.trace_reference is ~250 small launches and
three host waits; here a bounce is four launches: the closest-hit query,
``hit``, the any-hit query and ``nee``. Their plain twin is that eager
bounce, which trace_reference runs wherever these kernels do not (CPU
tensors, float64, gradients, the debug records).

The trace's state is a kernels/pbrt.Wavefront started without the pbrt
fields (``Wavefront.start(..., pbrt=False)``); the two kernels update it in
place. Each launch goes through build.launch on the current stream, waits
for nothing and allocates nothing; each counts its launches
(``hit.launches``, ``nee.launches``) and, for the program's own tracing,
one ``reference_kernel`` (utils/profiling.count) a launch.
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels.pbrt import Wavefront, _check, _faces, _lights
from pyrenderer_tpu_torch.utils.profiling import count

_WHO = "reference"
# the base face row (integrator.pack_face_data) the hit kernel reads: up
# to sided, column 14
_FACE_COLS = 15


def hit(wf: Wavefront, seed: int, bounce: int, rounds: int, hit_mask, tri, rows, gather: bool,
        light_data, light_nfaces, f_max: int, light_color, shadow_scale: float,
        t_max: float) -> None:
    """The hit half of reference bounce `bounce` (csrc/reference.cu
    reference_hit_kernel) after the closest query's (hit_mask, tri): the
    light color of a light hit into wf.radiance, wf.alive, the throughput
    wf.beta, the next ray and interval (wf.ro, wf.rd, wf.t1), and the shadow
    ray, NEE term and flags that the any-hit query and ``nee`` read.
    `rows`: the face table gathered by tri, or (not `gather`) the lanes' own
    rows; light_data (integrator.pack_light_data) and light_nfaces (L,) of L
    lights of f_max faces; light_color (3,) (TraceTables.light_color);
    shadow_scale the shadow ray's extent over the light's distance
    (1 - shadow_eps). One launch, none for no lanes."""
    dev, n = wf.ro.device, wf.ro.shape[0]
    counter, wide = wf._operands(seed, bounce, rounds, _WHO)
    _check(hit_mask, "hit", dev, torch.bool, (n,), _WHO)
    faces, wide_tri = _faces(rows, gather, tri, dev, n, _FACE_COLS, _WHO)
    lights, wide_l = _lights(light_data, light_nfaces, f_max, dev, _WHO)
    _check(light_color, "light_color", dev, torch.float32, (3,), _WHO)
    if n:
        build.launch(
            "pr_reference_hit", dev, *counter, wide | wide_tri | wide_l,
            wf.ro.data_ptr(), wf.rd.data_ptr(), hit_mask.data_ptr(), *faces, *lights,
            light_color.data_ptr(), float(shadow_scale), float(t_max), wf.beta.data_ptr(),
            wf.radiance.data_ptr(), wf.alive.data_ptr(), wf.t1.data_ptr(), wf.s_ro.data_ptr(),
            wf.s_rd.data_ptr(), wf.s_t1.data_ptr(), wf.nee.data_ptr(), wf.flags.data_ptr(),
            wf.n_rays.data_ptr())
        hit.launches += 1
        count("reference_kernel")


def nee(wf: Wavefront, occ) -> None:
    """The NEE half of a reference bounce (csrc/reference.cu
    reference_nee_kernel) after the any-hit query's `occ`: ``hit``'s NEE
    term into wf.radiance where the shadow ray is clear. One launch, none
    for no lanes."""
    dev, n = wf.ro.device, wf.ro.shape[0]
    _check(wf.flags, "flags", dev, torch.uint8, (n,), _WHO)
    _check(occ, "occ", dev, torch.bool, (n,), _WHO)
    for name in ("nee", "radiance"):
        _check(getattr(wf, name), name, dev, torch.float32, (n, 3), _WHO)
    if n:
        build.launch("pr_reference_nee", dev, n, wf.flags.data_ptr(), occ.data_ptr(),
                     wf.nee.data_ptr(), wf.radiance.data_ptr())
        nee.launches += 1
        count("reference_kernel")


def reset_counters() -> None:
    for fn in (hit, nee):
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()
