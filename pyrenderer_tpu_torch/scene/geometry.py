"""Primitive templates and the flat scene builder.

Quad/Cube vertex and face layouts match the reference's canonical meshes
(reference mathematics/shapes.py:19-27 Quad, :121-142 Cube) so that
transformed world geometry — and therefore images — line up exactly.

Normal convention (reference shapes.py:43-47, :176-180): per-face geometric
normals recomputed after transform as normalize(cross(e1, e2)), NEGATED for
quads, kept positive for cubes. We store only the ±1 sign per face and
recompute the normal from vertices inside the integrator so that gradients
w.r.t. vertex positions flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pyrenderer_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERT,
    MAT_LIGHT,
    MAT_METAL,
)
from pyrenderer_tpu_torch.scene.transforms import apply_transform

QUAD_VERTICES = np.array(
    [
        [-0.5, 0, -0.5],
        [0.5, 0, -0.5],
        [0.5, 0, 0.5],
        [-0.5, 0, 0.5],
    ],
    np.float64,
)
QUAD_FACES = np.array([[0, 1, 2], [2, 3, 0]], np.int32)

CUBE_VERTICES = np.array(
    [
        [-0.5, -0.5, -0.5], [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, -0.5, -0.5],
        [-0.5, 0.5, 0.5], [-0.5, 0.5, -0.5], [0.5, 0.5, -0.5], [0.5, 0.5, 0.5],
        [-0.5, 0.5, -0.5], [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5],
        [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [-0.5, -0.5, 0.5], [-0.5, 0.5, 0.5],
        [-0.5, 0.5, 0.5], [-0.5, -0.5, 0.5], [-0.5, -0.5, -0.5], [-0.5, 0.5, -0.5],
        [0.5, 0.5, -0.5], [0.5, -0.5, -0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5],
    ],
    np.float64,
)
CUBE_FACES = np.array(
    [
        [2, 1, 0], [0, 3, 2],
        [6, 5, 4], [4, 7, 6],
        [10, 9, 8], [8, 11, 10],
        [14, 13, 12], [12, 15, 14],
        [18, 17, 16], [16, 19, 18],
        [22, 21, 20], [20, 23, 22],
    ],
    np.int32,
)

def icosphere(subdivisions: int = 3):
    """Unit-radius icosphere: icosahedron + midpoint subdivision, vertices
    projected to the sphere. Returns (V, 3) float64, (T, 3) int32 with
    outward (counter-clockwise from outside) winding."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(verts[a]) + np.asarray(verts[b])
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


_MAT_CODES = {
    "lambert": MAT_LAMBERT,
    "null": MAT_LIGHT,
    "light": MAT_LIGHT,
    "metal": MAT_METAL,
    "mirror": MAT_METAL,
    "dielectric": MAT_DIELECTRIC,
    "glass": MAT_DIELECTRIC,
}


@dataclass
class MaterialSpec:
    name: str
    mat_type: int
    albedo: np.ndarray           # (3,)
    emission: np.ndarray         # (3,)
    emissive: int
    sided: int
    ior: float = 1.5
    roughness: float = 0.0

    @classmethod
    def from_tungsten(cls, info: dict) -> "MaterialSpec":
        """Tungsten bsdf dict → spec (reference core/bsdf.py:69 factory:
        'lambert' → Lambertian(sided=0), 'null' → Light(sided=1, scalar
        albedo))."""
        mtype = _MAT_CODES.get(info["type"])
        if mtype is None:
            raise NotImplementedError(f"bsdf type {info['type']!r} not implemented")
        albedo = info.get("albedo", 1.0)
        if np.isscalar(albedo):
            albedo = [albedo] * 3
        emissive = 1 if mtype == MAT_LIGHT else 0
        return cls(
            name=info.get("name", ""),
            mat_type=mtype,
            albedo=np.asarray(albedo, np.float64),
            emission=np.zeros(3),
            emissive=emissive,
            sided=1 if emissive else 0,
            ior=float(info.get("ior", 1.5)),
            roughness=float(info.get("roughness", 0.0)),
        )


@dataclass
class SceneBuilder:
    """Accumulates primitives into flat arrays; `finish()` → host Scene."""

    vertices: List[np.ndarray] = field(default_factory=list)
    faces: List[np.ndarray] = field(default_factory=list)
    normal_sign: List[np.ndarray] = field(default_factory=list)
    face_material: List[np.ndarray] = field(default_factory=list)
    materials: List[MaterialSpec] = field(default_factory=list)
    light_prim_faces: List[np.ndarray] = field(default_factory=list)
    _n_vertices: int = 0
    _n_faces: int = 0

    def add_material(self, spec: MaterialSpec) -> int:
        self.materials.append(spec)
        return len(self.materials) - 1

    def add_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        material_id: int,
        normal_sign: float = 1.0,
        transform: Optional[np.ndarray] = None,
    ) -> None:
        if transform is not None:
            vertices = apply_transform(transform, vertices)
        faces = np.asarray(faces, np.int32) + self._n_vertices
        n_f = faces.shape[0]
        self.vertices.append(np.asarray(vertices, np.float64))
        self.faces.append(faces)
        self.normal_sign.append(np.full(n_f, normal_sign))
        self.face_material.append(np.full(n_f, material_id, np.int32))
        if self.materials[material_id].emissive:
            self.light_prim_faces.append(
                np.arange(self._n_faces, self._n_faces + n_f, dtype=np.int32)
            )
        self._n_vertices += vertices.shape[0]
        self._n_faces += n_f

    def add_quad(self, transform: np.ndarray, material_id: int) -> None:
        # Quad face normals are negated (reference shapes.py:47).
        self.add_mesh(QUAD_VERTICES, QUAD_FACES, material_id, -1.0, transform)

    def add_cube(self, transform: np.ndarray, material_id: int) -> None:
        self.add_mesh(CUBE_VERTICES, CUBE_FACES, material_id, +1.0, transform)

    def add_sphere(
        self, transform: np.ndarray, material_id: int, subdivisions: int = 3
    ) -> None:
        """Unit-diameter icosphere (radius 0.5, matching the quad/cube
        canonical extent). The reference's spheres are analytic
        (intersection_taichi.py:15 hit_sphere, taichi_ref.py scene) — on a
        wavefront triangle pipeline tessellation keeps every primitive in
        the one hot kernel; subdivision 3 = 1280 faces is visually smooth."""
        verts, faces = icosphere(subdivisions)
        self.add_mesh(verts * 0.5, faces, material_id, +1.0, transform)

    def finish(self, dtype=np.float32):
        from pyrenderer_tpu_torch.scene.types import Scene

        if not self.light_prim_faces:
            raise ValueError("There is no lights!!!")  # reference intersection_taichi.py:233
        f_max = max(f.shape[0] for f in self.light_prim_faces)
        light_faces = np.stack(
            [np.pad(f, (0, f_max - f.shape[0]), mode="edge") for f in self.light_prim_faces]
        )
        light_nfaces = np.array([f.shape[0] for f in self.light_prim_faces], np.int32)
        mats = self.materials
        return Scene(
            vertices=np.concatenate(self.vertices).astype(dtype),
            faces=np.concatenate(self.faces),
            normal_sign=np.concatenate(self.normal_sign).astype(dtype),
            face_material=np.concatenate(self.face_material),
            albedo=np.stack([m.albedo for m in mats]).astype(dtype),
            emission=np.stack([m.emission for m in mats]).astype(dtype),
            emissive=np.array([m.emissive for m in mats], np.int32),
            sided=np.array([m.sided for m in mats], np.int32),
            mat_type=np.array([m.mat_type for m in mats], np.int32),
            ior=np.array([m.ior for m in mats], dtype),
            roughness=np.array([m.roughness for m in mats], dtype),
            light_faces=light_faces,
            light_nfaces=light_nfaces,
        )
