"""The pbrt estimator's bounce as two CUDA kernels: the wrapper.

The kernels (csrc/pbrt.cu) replace no TPU kernel: the JAX package's bounce
is jnp ops that XLA fuses. Eager PyTorch has no such fusion, so the eager
bounce of core/integrator_pbrt.py is ~400 small launches; here a bounce is
four: the closest-hit query, ``hit``, the any-hit query and ``scatter``.
Their plain twin is that eager bounce, which trace_pbrt runs wherever these
kernels do not (CPU tensors, float64, gradients).

A ``Wavefront`` holds the trace's state on the device, contiguous, and the
per-lane values that ``hit`` hands to ``scatter``; the two kernels update
it in place. The reference estimator's bounce kernels (kernels/reference.py)
take it too, without the fields only these kernels read. Each launch goes through build.launch on the current stream,
waits for nothing and allocates nothing; each counts its launches
(``hit.launches``, ``scatter.launches``) and, for the program's own
tracing, one ``pbrt_kernel`` (utils/profiling.count) a launch.
"""

from __future__ import annotations

import dataclasses

import torch

from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels.threefry import _lanes
from pyrenderer_tpu_torch.utils.profiling import count

_U32 = 0xFFFFFFFF
# the extended face row (integrator.pack_face_data) the kernels read: up
# to light_pdf_A, column 21
_FACE_COLS = 22
_LIGHT_COLS = 14


def _check(x, name, device, dtype, shape, who="pbrt"):
    """Refuse an operand the kernels cannot take: another device or dtype,
    another shape, or not contiguous. `who` names the kernels in the
    message."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{who}: {name} is a {x.dtype} {tuple(x.shape)} tensor on {x.device}, "
                         f"the kernel takes {dtype} {shape} on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def _table(x, name, device, cols, who="pbrt"):
    """A float32 table on `device` whose rows are read through their
    stride: at least `cols` unit-stride columns."""
    if x.device != device or x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] < cols:
        raise ValueError(f"{who}: {name} is a {x.dtype} {tuple(x.shape)} tensor on {x.device}, "
                         f"the kernel takes float32 rows of at least {cols} columns on {device}")
    if x.stride(1) != 1:
        raise ValueError(f"{who}: {name}'s columns are not contiguous")


def _ids(x, name, device, n, who="pbrt"):
    """An int32 or int64 operand of n lanes on `device`, read through its
    stride: (tensor, stride, wide)."""
    if x.device != device or x.dtype not in (torch.int32, torch.int64) or x.shape != (n,):
        raise ValueError(f"{who}: {name} is a {x.dtype} {tuple(x.shape)} tensor on {x.device}, "
                         f"the kernel takes int32 or int64 ({n},) on {device}")
    return x, x.stride(0), x.dtype == torch.int64


@dataclasses.dataclass
class Wavefront:
    """The state of a pbrt trace on the device, and the values ``hit`` hands
    to ``scatter``: n lanes, float32 rows of three, all contiguous.

    ro, rd: the rays; beta, radiance: throughput and radiance; alive;
    prev_pdf, prev_spec: the last scatter's pdf and whether it was
    specular; t1: the next closest query's interval (t_max where alive,
    else 0); pixel, sample: the counter operands (sample None where it is
    the one value sample_const); n_rays: the rays traced (a float32
    scalar, as the eager trace counts them); closest_rays, shadow_rays:
    the lanes ``hit`` found live on entry (those the closest query
    tested) and those it gave a shadow ray with an open interval (those
    the any-hit query tests), float32 scalars that share one tensor with
    n_rays, so that one fill zeroes all three. Written by ``hit``: the
    shadow ray s_ro, s_rd, s_t1, the shading normal nrm, the NEE term
    nee of a clear shadow ray, flags. prev_pdf, prev_spec and nrm are None
    in a wavefront started for the reference estimator's kernels."""

    ro: torch.Tensor
    rd: torch.Tensor
    beta: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    prev_pdf: torch.Tensor | None
    prev_spec: torch.Tensor | None
    t1: torch.Tensor
    pixel: torch.Tensor
    sample: torch.Tensor | None
    sample_const: int
    n_rays: torch.Tensor
    closest_rays: torch.Tensor
    shadow_rays: torch.Tensor
    s_ro: torch.Tensor
    s_rd: torch.Tensor
    s_t1: torch.Tensor
    nrm: torch.Tensor | None
    nee: torch.Tensor
    flags: torch.Tensor

    @classmethod
    def start(cls, ro, rd, pixel, sample, t_max: float, pbrt: bool = True) -> "Wavefront":
        """A fresh wavefront on copies of the rays ro, rd (N, 3): beta 1,
        radiance 0, every lane alive with t1 = t_max, prev_pdf 1. `pixel`
        is an integer tensor broadcast to (N,), `sample` an int, a CPU
        scalar or an integer tensor on the rays' device, one value or (N,)
        (as kernels/threefry.py takes it). Without `pbrt`, the fields only
        the pbrt kernels read (prev_pdf, prev_spec, nrm) are None."""
        n, dev = ro.shape[0], ro.device
        ro = ro.clone(memory_format=torch.contiguous_format)
        rd = rd.clone(memory_format=torch.contiguous_format)
        if pixel.dtype not in (torch.int32, torch.int64):
            pixel = pixel.to(torch.int64)
        pixel = pixel.expand(n)
        sample_t, sample_const = _lanes(sample, "sample", dev)
        if sample_t is not None:
            if sample_t.dtype not in (torch.int32, torch.int64):
                sample_t = sample_t.to(torch.int64)
            sample_t = sample_t.expand(n)
        empty3 = lambda: torch.empty((n, 3), dtype=torch.float32, device=dev)  # noqa: E731
        counts = torch.zeros(3, dtype=torch.float32, device=dev)
        return cls(
            ro=ro, rd=rd, beta=torch.ones_like(ro), radiance=torch.zeros_like(ro),
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            prev_pdf=torch.ones(n, dtype=torch.float32, device=dev) if pbrt else None,
            prev_spec=torch.zeros(n, dtype=torch.bool, device=dev) if pbrt else None,
            t1=torch.full((n,), t_max, dtype=torch.float32, device=dev),
            pixel=pixel, sample=sample_t, sample_const=sample_const & _U32,
            n_rays=counts[0], closest_rays=counts[1], shadow_rays=counts[2],
            s_ro=empty3(), s_rd=empty3(), s_t1=torch.empty(n, dtype=torch.float32, device=dev),
            nrm=empty3() if pbrt else None, nee=empty3(),
            flags=torch.empty(n, dtype=torch.uint8, device=dev))

    def _operands(self, seed: int, bounce: int, rounds: int, who: str = "pbrt"):
        """The counter's arguments of the C entry points that draw, and the
        checks of the state they write (a None field is refused where
        `who` is "pbrt")."""
        n, dev = self.ro.shape[0], self.ro.device
        for name, shape in (("ro", (n, 3)), ("rd", (n, 3)), ("beta", (n, 3)),
                            ("radiance", (n, 3)), ("prev_pdf", (n,)), ("t1", (n,)),
                            ("s_ro", (n, 3)), ("s_rd", (n, 3)), ("s_t1", (n,)),
                            ("nrm", (n, 3)), ("nee", (n, 3))):
            self._field(name, torch.float32, shape, who)
        for name in ("alive", "prev_spec"):
            self._field(name, torch.bool, (n,), who)
        _check(self.flags, "flags", dev, torch.uint8, (n,), who)
        _check(self.n_rays, "n_rays", dev, torch.float32, (), who)
        pixel, pixel_stride, wide = _ids(self.pixel, "pixel", dev, n, who)
        sample_ptr, sample_stride = None, 0
        if self.sample is not None:
            sample, sample_stride, wide_s = _ids(self.sample, "sample", dev, n, who)
            sample_ptr = sample.data_ptr()
            wide |= wide_s << 1
        return [n, bounce, int(seed & _U32), rounds, pixel.data_ptr(), pixel_stride, sample_ptr,
                sample_stride, (self.sample_const << 12) & _U32], int(wide)

    def _field(self, name, dtype, shape, who):
        """_check of field `name`; the pbrt-only fields may be None for
        another estimator's kernels."""
        x = getattr(self, name)
        if x is None and who != "pbrt" and name in ("prev_pdf", "prev_spec", "nrm"):
            return
        if x is None:
            raise ValueError(f"{who}: the wavefront has no {name} (started without pbrt)")
        _check(x, name, self.ro.device, dtype, shape, who)


def _faces(rows, gather: bool, tri, dev, n, cols=_FACE_COLS, who="pbrt"):
    """The face-row operands: rows (T, K >= cols) gathered by the hit ids,
    or the lanes' own rows (N, K) where not `gather`; (args, wide bit 2)."""
    _table(rows, "rows", dev, cols, who)
    if not gather and rows.shape[0] != n:
        raise ValueError(f"{who}: {rows.shape[0]} face rows for {n} lanes")
    tri, _, wide = _ids(tri, "tri", dev, n, who)
    if tri.stride(0) != 1:
        raise ValueError(f"{who}: tri is not contiguous")
    return [tri.data_ptr(), rows.data_ptr(), rows.stride(0), int(gather)], int(wide) << 2


def _lights(light_data, light_nfaces, f_max: int, dev, who="pbrt"):
    """The light operands: light_data (integrator.pack_light_data) and
    light_nfaces (L,) of L lights of f_max faces; (args, wide bit 3)."""
    _table(light_data, "light_data", dev, _LIGHT_COLS, who)
    n_lights = light_nfaces.shape[0]
    nfaces, _, wide = _ids(light_nfaces, "light_nfaces", dev, n_lights, who)
    if nfaces.stride(0) != 1 or light_data.shape[0] != n_lights * f_max:
        raise ValueError(f"{who}: light_nfaces {tuple(nfaces.shape)} (stride "
                         f"{nfaces.stride(0)}) and {light_data.shape[0]} light rows for "
                         f"{f_max} faces a light")
    return ([light_data.data_ptr(), light_data.stride(0), nfaces.data_ptr(), n_lights, f_max],
            int(wide) << 3)


def hit(wf: Wavefront, seed: int, bounce: int, rounds: int, hit_mask, tri, rows, gather: bool,
        light_data, light_nfaces, f_max: int, shadow_scale: float) -> None:
    """The hit half of pbrt bounce `bounce` (csrc/pbrt.cu pbrt_hit_kernel)
    after the closest query's (hit_mask, tri): emission with its MIS weight
    into wf.radiance, wf.alive, and the shadow ray, normal, NEE term and
    flags that ``scatter`` reads. `rows`: the extended face table gathered
    by tri, or (not `gather`) the lanes' own rows; light_data
    (integrator.pack_light_data) and light_nfaces (L,) of L lights of
    f_max faces; shadow_scale the shadow ray's extent over the light's
    distance (1 - shadow_eps). Adds its lanes to wf.n_rays,
    wf.closest_rays and wf.shadow_rays. One launch, none for no lanes."""
    dev, n = wf.ro.device, wf.ro.shape[0]
    counter, wide = wf._operands(seed, bounce, rounds)
    _check(hit_mask, "hit", dev, torch.bool, (n,))
    for name in ("closest_rays", "shadow_rays"):
        _check(getattr(wf, name), name, dev, torch.float32, ())
    faces, wide_tri = _faces(rows, gather, tri, dev, n)
    lights, wide_l = _lights(light_data, light_nfaces, f_max, dev)
    if n:
        build.launch(
            "pr_pbrt_hit", dev, *counter, wide | wide_tri | wide_l,
            wf.ro.data_ptr(), wf.rd.data_ptr(), hit_mask.data_ptr(), *faces,
            *lights, wf.beta.data_ptr(), wf.radiance.data_ptr(),
            wf.alive.data_ptr(), wf.prev_pdf.data_ptr(), wf.prev_spec.data_ptr(),
            float(shadow_scale), wf.s_ro.data_ptr(), wf.s_rd.data_ptr(), wf.s_t1.data_ptr(),
            wf.nrm.data_ptr(), wf.nee.data_ptr(), wf.flags.data_ptr(), wf.n_rays.data_ptr(),
            wf.closest_rays.data_ptr(), wf.shadow_rays.data_ptr())
        hit.launches += 1
        count("pbrt_kernel")


def scatter(wf: Wavefront, seed: int, bounce: int, rounds: int, tri, rows, gather: bool,
            occ, roulette: bool, t_max: float) -> None:
    """The scatter half of pbrt bounce `bounce` (csrc/pbrt.cu
    pbrt_scatter_kernel) after the any-hit query's `occ`: the NEE term of
    a clear shadow ray, the lane's BSDF sampler, the throughput, Russian
    roulette where `roulette`, and the next ray and interval, all in
    place in `wf`. tri, rows, gather as ``hit`` took them. One launch,
    none for no lanes."""
    dev, n = wf.ro.device, wf.ro.shape[0]
    counter, wide = wf._operands(seed, bounce, rounds)
    faces, wide_tri = _faces(rows, gather, tri, dev, n)
    _check(occ, "occ", dev, torch.bool, (n,))
    if n:
        build.launch(
            "pr_pbrt_scatter", dev, *counter, wide | wide_tri, *faces, occ.data_ptr(),
            wf.s_ro.data_ptr(), wf.nrm.data_ptr(), wf.nee.data_ptr(), wf.flags.data_ptr(),
            wf.ro.data_ptr(), wf.rd.data_ptr(), wf.beta.data_ptr(), wf.radiance.data_ptr(),
            wf.alive.data_ptr(), wf.prev_pdf.data_ptr(), wf.prev_spec.data_ptr(),
            wf.t1.data_ptr(), int(roulette), float(t_max), wf.n_rays.data_ptr())
        scatter.launches += 1
        count("pbrt_kernel")


def reset_counters() -> None:
    for fn in (hit, scatter):
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()
