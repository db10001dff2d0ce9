"""The benchmark's scene loader for scenes with spheres, metal and glass:
benchmark/reference/scene.py's load, with tessellated spheres and the
metal and dielectric materials added, in NumPy.

It is built on scene.py by import: a scene without spheres and specular
materials goes to scene.load itself, and the others through the same
steps with scene.py's transforms, view matrix, quad and cube templates
and lambert and light materials, to the same flat arrays, field for
field. What it adds is a
frozen copy of the port's scene/geometry.py icosphere and
SceneBuilder.add_sphere (a unit-diameter icosphere, subdivision 3 unless
the primitive says otherwise, its normals' sign +1) and of its material
codes and parameters (MaterialSpec.from_tungsten: "metal" and "mirror" are
metal, "dielectric" and "glass" dielectric; "roughness" 0 and "ior" 1.5
where the bsdf gives none; an emissive clone keeps both), so that a later
change to the program's loader cannot change the benchmark's inputs. It
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import scene as base

MAT_LAMBERT, MAT_LIGHT, MAT_METAL, MAT_DIELECTRIC = 0, 1, 2, 3
_MAT_CODES = {"lambert": MAT_LAMBERT, "null": MAT_LIGHT, "light": MAT_LIGHT,
              "metal": MAT_METAL, "mirror": MAT_METAL,
              "dielectric": MAT_DIELECTRIC, "glass": MAT_DIELECTRIC}


def icosphere(subdivisions: int = 3):
    """Unit-radius icosphere: the icosahedron, each face split in four
    `subdivisions` times, new vertices projected to the sphere; (V, 3)
    float64 and (T, 3) int32, wound counter-clockwise from outside."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
         [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
         [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
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


def _material(info: dict) -> dict:
    mtype = _MAT_CODES.get(info["type"])
    if mtype is None:
        raise ValueError(f"bsdf type {info['type']!r}: not a benchmark material")
    mat = base._material(dict(info, type="null" if mtype == MAT_LIGHT else "lambert"))
    return dict(mat, mat_type=mtype, ior=float(info.get("ior", 1.5)),
                roughness=float(info.get("roughness", 0.0)))


def load(scene: dict) -> tuple:
    """(arrays, camera) of a Tungsten scene dict, as base.load makes them,
    with "sphere" primitives and metal and dielectric materials; ior and
    roughness hold each material's own."""
    if not any(p["type"] == "sphere" for p in scene["primitives"]) and not any(
            _material(b)["mat_type"] >= MAT_METAL for b in scene.get("bsdfs", [])):
        return base.load(scene)
    mats, names = [], {}
    for info in scene.get("bsdfs", []):
        names[info["name"]] = len(mats)
        mats.append(_material(info))
    verts, faces, signs, face_mat, lights = [], [], [], [], []
    n_v = n_f = 0
    for info in scene["primitives"]:
        mat = names[info["bsdf"]]
        if "emission" in info:
            em = np.asarray(info["emission"], np.float64)
            mats.append(dict(mats[mat], emission=np.broadcast_to(em, (3,)).copy(),
                             emissive=1, sided=1))
            mat = len(mats) - 1
        kind = info["type"]
        if kind == "quad":
            v, f, sign = base.QUAD_VERTICES, base.QUAD_FACES, -1.0
        elif kind == "cube":
            v, f, sign = base.CUBE_VERTICES, base.CUBE_FACES, 1.0
        elif kind == "sphere":
            v, f = icosphere(int(info.get("subdivisions", 3)))
            v, sign = v * 0.5, 1.0
        else:
            raise ValueError(f"primitive {kind!r}: not a benchmark primitive")
        m = base.transform_matrix(info.get("transform", {}))
        v = (m @ np.concatenate([v, np.ones((v.shape[0], 1))], axis=1).T).T[:, :3]
        verts.append(v)
        faces.append(np.asarray(f, np.int32) + n_v)
        signs.append(np.full(f.shape[0], sign))
        face_mat.append(np.full(f.shape[0], mat, np.int32))
        if mats[mat]["emissive"]:
            lights.append(np.arange(n_f, n_f + f.shape[0], dtype=np.int32))
        n_v += v.shape[0]
        n_f += f.shape[0]
    if not lights:
        raise ValueError("the scene has no light")
    f_max = max(x.shape[0] for x in lights)
    arrays = dict(
        vertices=np.concatenate(verts).astype(np.float32),
        faces=np.concatenate(faces),
        normal_sign=np.concatenate(signs).astype(np.float32),
        face_material=np.concatenate(face_mat),
        albedo=np.stack([m["albedo"] for m in mats]).astype(np.float32),
        emission=np.stack([m["emission"] for m in mats]).astype(np.float32),
        emissive=np.array([m["emissive"] for m in mats], np.int32),
        sided=np.array([m["sided"] for m in mats], np.int32),
        mat_type=np.array([m["mat_type"] for m in mats], np.int32),
        ior=np.array([m["ior"] for m in mats], np.float32),
        roughness=np.array([m["roughness"] for m in mats], np.float32),
        light_faces=np.stack([np.pad(x, (0, f_max - x.shape[0]), mode="edge")
                              for x in lights]),
        light_nfaces=np.array([x.shape[0] for x in lights], np.int32),
    )
    cam = scene["camera"]
    tf = cam["transform"]
    camera = dict(
        iview=np.linalg.inv(base.look_at_rowvec(tf["position"], tf["look_at"], tf["up"]))
        .astype(np.float32),
        fov_deg=np.float32(cam.get("fov", 90.0)),
        focal_dist=np.float32(cam.get("focal_dist", 1.0)),
        aperture=np.float32(cam.get("aperture", 0.0)),
        resolution=tuple(int(x) for x in cam["resolution"]),
    )
    return arrays, camera
