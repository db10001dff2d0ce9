"""Flat scene representation, and the state-carry function ``to_device``.

Counterpart of pyrenderer_tpu/scene/types.py. A scene is a handful of flat
arrays. The loaders (scene/tungsten.py) return them as NumPy arrays on the
host; ``to_device`` turns a host Scene/Camera -- this package's or the JAX
package's, which share field names and layout -- into torch tensors on one
device, so both packages can render from identical data.

Material type codes (mat_type):
    0 = lambert     (reference core/bsdf.py:19 BSDFLambertian)
    1 = light       (reference core/bsdf.py:46 BSDFLight, Tungsten "null")
    2 = metal       (reference core/bsdf_taichi.py:46 Metal)
    3 = dielectric  (reference core/bsdf_taichi.py:62 Dielectric)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

MAT_LAMBERT = 0
MAT_LIGHT = 1
MAT_METAL = 2
MAT_DIELECTRIC = 3


class Scene(NamedTuple):
    """Triangle-soup scene. Shapes: V vertices, T faces, M materials, L light
    prims. Each field is a NumPy array on the host or a tensor on a device."""

    vertices: Any       # (V, 3) float
    faces: Any          # (T, 3) int -- indices into vertices
    normal_sign: Any    # (T,) float -- face normal = sign * normalize(cross(e1, e2))
    face_material: Any  # (T,) int -- index into the material table

    albedo: Any         # (M, 3) float
    emission: Any       # (M, 3) float -- radiance ("pbrt" estimator)
    emissive: Any       # (M,) int -- 1 for lights
    sided: Any          # (M,) int -- 1: keep stored normal; 0: flip toward -rd
    mat_type: Any       # (M,) int -- MAT_* code
    ior: Any            # (M,) float -- dielectric index of refraction
    roughness: Any      # (M,) float -- metal fuzz

    # uniform pick of a light prim, then a uniform face inside it
    light_faces: Any    # (L, F_max) int -- face ids, padded by repeating face 0
    light_nfaces: Any   # (L,) int -- real face count per light prim


class Camera(NamedTuple):
    """Pinhole camera with optional square aperture (reference core/camera.py:13).

    ``iview`` is the inverse of the row-vector-convention look-at matrix:
    world = homogeneous(cam) @ iview (reference core/camera.py:63-64).
    """

    iview: Any          # (4, 4) float
    fov_deg: Any        # () float
    focal_dist: Any     # () float
    aperture: Any       # () float
    resolution: Tuple[int, int]  # (W, H)


def _carry(x, device, dtype):
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr, dtype=dtype, device=device)
    return torch.as_tensor(arr.astype(np.int64), device=device)


def to_device(scene, camera, device, dtype=torch.float32):
    """Host Scene and Camera (NumPy arrays, from either package's loader)
    -> this package's Scene and Camera of tensors on `device`.

    Float arrays become `dtype`, integer arrays int64 (torch's index type);
    the camera's scalars become 0-d tensors. Values are carried unchanged
    apart from the float cast."""
    device = torch.device(device)
    scene_t = Scene(*[_carry(x, device, dtype) for x in scene])
    camera_t = Camera(
        iview=_carry(camera.iview, device, dtype),
        fov_deg=_carry(camera.fov_deg, device, dtype),
        focal_dist=_carry(camera.focal_dist, device, dtype),
        aperture=_carry(camera.aperture, device, dtype),
        resolution=tuple(int(r) for r in camera.resolution),
    )
    return scene_t, camera_t


def scene_to_numpy(scene: Scene) -> Scene:
    """Host copy of every array (for the NumPy oracle and the tests)."""
    return Scene(*[x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                   for x in scene])
