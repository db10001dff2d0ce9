"""Typed render configuration, honoring Tungsten's integrator/renderer blocks.

The reference parses scene.json's ``integrator`` and ``renderer`` sections
but ignores every field (SURVEY §5.6; scene.json:270-292); bounce depth and
spp are hardcoded at its entry points (main_taichi.py:29,:37). Here they are
one frozen dataclass with CLI overrides.

``estimator`` selects the radiance estimator:
  - "reference": reproduces core/tracing.py:117 semantics exactly — the
    hardcoded light color (tracing.py:120), NEE without area pdf or 1/pi
    (tracing.py:92-108), no russian roulette, no MIS.
  - "pbrt": physically-based — scene emission, NEE with area-measure pdf and
    power-heuristic MIS (the algorithm of taichi_ref.py:368 and the unused
    tracing.py:56 sample_direct_lighting2), russian roulette, full material
    set (lambert/metal/dielectric).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    max_bounces: int = 16          # reference main_taichi.py:37
    spp: int = 64                  # reference main_taichi.py:29 / scene.json spp
    spp_step: int = 1              # samples per progressive pass
    estimator: str = "reference"   # "reference" | "pbrt"
    seed: int = 0
    russian_roulette_start: int = 4   # pbrt mode only; bounce at which RR kicks in
    tonemap: str = "sqrt"          # "sqrt" (main_taichi.py:61) | "reinhard" (:67) |
    #                                "filmic" (Hable; Tungsten scene.json:277) | "none"
    preview_interval: int = 0      # passes between preview PNG dumps; 0 = off
    #                                (reference dumped out.png every 100 passes,
    #                                 main_taichi.py:119-125)
    preview_file: str = "preview.png"
    stratified: bool = False       # jittered-grid pixel sampling (Tungsten stratified_sampler)
    adaptive: bool = False         # variance-guided sample allocation (Tungsten adaptive_sampling)
    adaptive_min_spp: int = 8      # uniform spp before adaptivity kicks in
    adaptive_tolerance: float = 0.02  # stop refining a pixel below this relative error
    shadow_eps: float = 1e-3       # relative margin excluding the sampled light face
    cluster_watertight: bool | str = "auto"  # cluster-backend leaves use
    #                                the PBRT shear watertight test instead
    #                                of plain Moeller-Trumbore (leak-free
    #                                shared edges; reference
    #                                intersection_taichi.py:94 exists for
    #                                the same reason). "auto" = watertight
    #                                for scenes of at least
    #                                integrator.AUTO_SORT_MIN_CLUSTERS
    #                                clusters (~32k triangles), MT below, as
    #                                the JAX package chooses; True/False
    #                                force it (integrator.
    #                                resolve_cluster_watertight). The JAX
    #                                package set the threshold from the
    #                                leaf's cost measured on a TPU; not
    #                                measured on this card (ROADMAP A10).
    cluster_sort: object = "auto"  # coherence-sort wavefronts before each
    #                                cluster query (accel/clusters.sort_keys:
    #                                origin Morton | quantized direction,
    #                                dead lanes last). True | False | "auto":
    #                                sort scenes of at least
    #                                integrator.AUTO_SORT_MIN_CLUSTERS
    #                                clusters. The crossover was measured on
    #                                a TPU; not measured on this card
    #                                (ROADMAP A10).
    cluster_rounds: int = 1        # suspend/resume passes for cluster
    #                                closest-hit: pass 1 sweeps at most
    #                                cluster_budget superclusters per tile
    #                                (front to back), then unresolved rays
    #                                are finished unbudgeted. Only 1 (a
    #                                single exhaustive sweep) is ported;
    #                                more raises NotImplementedError
    #                                (ROADMAP A10). The JAX default of 1 was
    #                                chosen from a TPU measurement; not
    #                                measured on this card.
    cluster_budget: int = 8        # supercluster visit budget per ray tile
    #                                in pass 1; only read when
    #                                cluster_rounds > 1.
    # The binned backends' candidate bins per ray and pass (kernels/binned.py
    # W_SLOTS = 6, W_SLOTS_STREAMED = 10, env PYRENDERER_BINNED_W) are the
    # JAX package's values, chosen on a TPU; not measured on this card.
    t_min: float = 1e-5            # reference tracing.py:125 hit epsilon
    t_max: float = 99999.9         # reference tracing.py:125
    output_file: str = "out.png"
    hdr_output_file: Optional[str] = None
    checkpoint_interval: int = 0   # passes between checkpoint dumps; 0 = off
    resolution: Optional[Tuple[int, int]] = None  # override camera resolution

    @classmethod
    def from_tungsten(cls, data: dict) -> "RenderConfig":
        integ = data.get("integrator", {})
        rend = data.get("renderer", {})
        return cls(
            max_bounces=int(integ.get("max_bounces", 16)),
            spp=int(rend.get("spp", 64)),
            spp_step=int(rend.get("spp_step", 1)),
            tonemap=(
                data.get("camera", {}).get("tonemap")
                if data.get("camera", {}).get("tonemap")
                in ("filmic", "reinhard", "sqrt", "none")
                else "sqrt"
            ),
            stratified=bool(rend.get("stratified_sampler", False)),
            adaptive=bool(rend.get("adaptive_sampling", False)),
            output_file=rend.get("output_file", "out.png"),
            hdr_output_file=rend.get("hdr_output_file"),
            checkpoint_interval=int(rend.get("checkpoint_interval", 0) or 0),
        )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
