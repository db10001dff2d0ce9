"""Tungsten JSON scene loader → flat Scene + Camera + RenderConfig.

Reference: io_utils/read_tungsten.py:43 read_file / :15 process_primitives.
Differences by design:
  - primitives with an "emission" field get a per-primitive material clone
    carrying that radiance (the reference parses but ignores emission —
    its light uses a hardcoded color, core/tracing.py:120);
  - the integrator/renderer blocks are honored into RenderConfig instead of
    being ignored (reference parses scene.json:270-292 but never reads them).
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import Tuple

import numpy as np

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.scene.geometry import MaterialSpec, SceneBuilder
from pyrenderer_tpu_torch.scene.transforms import (
    look_at_rowvec,
    make_transformation_matrix,
)
from pyrenderer_tpu_torch.scene.types import Camera, Scene


def _build_camera(data: dict, dtype=np.float32) -> Camera:
    cam = data["camera"]
    tf = cam["transform"]
    view = look_at_rowvec(tf["position"], tf["look_at"], tf["up"])
    iview = np.linalg.inv(view)
    res = tuple(int(x) for x in cam["resolution"])
    return Camera(
        iview=iview.astype(dtype),
        fov_deg=np.asarray(cam.get("fov", 90.0), dtype),
        focal_dist=np.asarray(cam.get("focal_dist", 1.0), dtype),
        aperture=np.asarray(cam.get("aperture", 0.0), dtype),
        resolution=res,
    )


def build_scene(
    data: dict, dtype=np.float32, base_dir: str | None = None
) -> Tuple[Scene, Camera, RenderConfig]:
    builder = SceneBuilder()
    name_to_mat = {}
    mat_specs = {}
    for info in data.get("bsdfs", []):
        spec = MaterialSpec.from_tungsten(info)
        mat_specs[spec.name] = spec
        name_to_mat[spec.name] = builder.add_material(spec)

    for info in data.get("primitives", []):
        ptype = info.get("type")
        if ptype not in ("quad", "cube", "mesh", "sphere"):
            # reference read_tungsten.py:34 warns and skips unknown prims
            print(f"[WARNING] {ptype} not implemented")
            continue
        mat_id = name_to_mat[info["bsdf"]]
        if "emission" in info:
            em = np.asarray(info["emission"], np.float64)
            if em.ndim == 0:
                em = np.full(3, float(em))
            spec = replace(mat_specs[info["bsdf"]], emission=em, emissive=1, sided=1)
            mat_id = builder.add_material(spec)
        trans = make_transformation_matrix(info.get("transform", {}))
        if ptype == "quad":
            builder.add_quad(trans, mat_id)
        elif ptype == "cube":
            builder.add_cube(trans, mat_id)
        elif ptype == "sphere":
            builder.add_sphere(trans, mat_id, int(info.get("subdivisions", 3)))
        else:  # "mesh": .obj file (path relative to the scene json), or
            # in-memory "vertices"/"faces" arrays (procedural scenes)
            if "vertices" in info:
                verts = np.asarray(info["vertices"], np.float64)
                faces = np.asarray(info["faces"], np.int32)
            else:
                from pyrenderer_tpu_torch.scene.obj import load_obj

                obj_path = info["file"]
                if base_dir is not None and not os.path.isabs(obj_path):
                    obj_path = os.path.join(base_dir, obj_path)
                verts, faces = load_obj(obj_path)
            builder.add_mesh(verts, faces, mat_id, normal_sign=1.0, transform=trans)

    scene = builder.finish(dtype=dtype)
    from pyrenderer_tpu_torch.utils.checks import validate_scene

    validate_scene(scene)  # load-time gate: fail here, not obscurely mid-trace
    camera = _build_camera(data, dtype=dtype)
    config = RenderConfig.from_tungsten(data)
    return scene, camera, config


def load_tungsten(path: str, dtype=np.float32) -> Tuple[Scene, Camera, RenderConfig]:
    with open(path) as f:
        data = json.load(f)
    return build_scene(data, dtype=dtype, base_dir=os.path.dirname(os.path.abspath(path)))
