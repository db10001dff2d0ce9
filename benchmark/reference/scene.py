"""The benchmark's own scene loader: a configuration's Tungsten scene dict
to flat triangle arrays, in NumPy.

Both sides get what this module makes: the harness fills the program's
Scene with these arrays, and the plain reference reads the same arrays. It
is a frozen copy of the port's scene/tungsten.py, scene/geometry.py,
scene/transforms.py and scene/procgen.py (the parts a benchmark scene
uses: quads, cubes, meshes, lambert and null materials, primitive
emission, the terrain heightfield), so a later change to the program's
loader cannot change the benchmark's inputs. It imports nothing of the
program.

A mesh primitive may carry ``"procgen": {"kind": "terrain", "res": ...,
"roughness": ..., "seed": ...}`` in place of vertex arrays: the
heightfield is made here from those numbers.
"""

from __future__ import annotations

from math import radians

import numpy as np

MAT_LAMBERT, MAT_LIGHT = 0, 1
_MAT_CODES = {"lambert": MAT_LAMBERT, "null": MAT_LIGHT, "light": MAT_LIGHT}

QUAD_VERTICES = np.array(
    [[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]], np.float64)
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
    [[2, 1, 0], [0, 3, 2], [6, 5, 4], [4, 7, 6], [10, 9, 8], [8, 11, 10],
     [14, 13, 12], [12, 15, 14], [18, 17, 16], [16, 19, 18], [22, 21, 20], [20, 23, 22]],
    np.int32,
)


def _axis_rotation(axis, degrees):
    a = radians(degrees)
    c, s = np.cos(a), np.sin(a)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def transform_matrix(tf: dict) -> np.ndarray:
    """Tungsten transform dict -> 4x4, translation @ rotation @ scale, the
    rotation composed R = R @ rot(axis) over the nonzero axes x, y, z."""
    out = np.eye(4)
    if "position" in tf:
        m = np.eye(4)
        m[:3, 3] = tf["position"]
        out = out @ m
    if "rotation" in tf:
        rot = np.eye(3)
        for axis, deg in enumerate(tf["rotation"]):
            if deg != 0:
                rot = rot @ _axis_rotation(axis, deg)
        m = np.eye(4)
        m[:3, :3] = rot
        out = out @ m
    if "scale" in tf:
        m = np.eye(4)
        m[0, 0], m[1, 1], m[2, 2] = tf["scale"]
        out = out @ m
    return out


def look_at_rowvec(eye, target, up) -> np.ndarray:
    """Row-vector view matrix (world row vector @ view = camera space)."""
    eye, target, up = (np.asarray(x, np.float64) for x in (eye, target, up))
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    side = np.cross(forward, up)
    side = side / np.linalg.norm(side)
    up2 = np.cross(side, forward)
    view = np.eye(4)
    view[:3, 0] = side
    view[:3, 1] = up2
    view[:3, 2] = -forward
    view[3, 0] = -side @ eye
    view[3, 1] = -up2 @ eye
    view[3, 2] = forward @ eye
    return view


def terrain(res: int, roughness: float, seed: int):
    """Fractal midpoint-displacement heightfield on a (res+1)^2 grid:
    (vertices (V, 3) float64, faces (2 res^2, 3) int32)."""
    rng = np.random.default_rng(seed)
    size = 2
    h = rng.standard_normal((size, size))
    amp = 1.0
    while size <= res:
        new = np.empty((2 * size - 1, 2 * size - 1))
        new[::2, ::2] = h
        new[1::2, ::2] = 0.5 * (h[:-1, :] + h[1:, :])
        new[::2, 1::2] = 0.5 * (h[:, :-1] + h[:, 1:])
        new[1::2, 1::2] = 0.25 * (h[:-1, :-1] + h[1:, :-1] + h[:-1, 1:] + h[1:, 1:])
        amp *= roughness
        new += amp * rng.standard_normal(new.shape)
        h = new
        size = h.shape[0]
    h = h[: res + 1, : res + 1]
    h = (h - h.min()) / max(h.max() - h.min(), 1e-9)
    ys, xs = np.mgrid[0 : res + 1, 0 : res + 1] / res
    verts = np.stack([xs.ravel() - 0.5, 0.35 * h.ravel(), ys.ravel() - 0.5], axis=1)
    i = (np.arange(res)[:, None] * (res + 1) + np.arange(res)[None, :]).ravel()
    quad = np.stack([i, i + 1, i + res + 2, i, i + res + 2, i + res + 1], axis=1)
    return verts, quad.reshape(-1, 3).astype(np.int32)


def _material(info: dict) -> dict:
    mtype = _MAT_CODES.get(info["type"])
    if mtype is None:
        raise ValueError(f"bsdf type {info['type']!r}: not a benchmark material")
    albedo = info.get("albedo", 1.0)
    if np.isscalar(albedo):
        albedo = [albedo] * 3
    light = mtype == MAT_LIGHT
    return dict(albedo=np.asarray(albedo, np.float64), emission=np.zeros(3),
                emissive=int(light), sided=int(light), mat_type=mtype)


def load(scene: dict) -> tuple:
    """(arrays, camera) of a Tungsten scene dict. `arrays` holds the
    fields of a flat scene (vertices float32 (V, 3), faces int32 (T, 3),
    normal_sign, face_material, the material table albedo, emission,
    emissive, sided, mat_type, ior, roughness, and light_faces (L, F_max)
    padded by repeating a prim's last face, light_nfaces); `camera` holds
    iview (4, 4) float32, fov_deg, focal_dist, aperture and resolution."""
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
            v, f, sign = QUAD_VERTICES, QUAD_FACES, -1.0
        elif kind == "cube":
            v, f, sign = CUBE_VERTICES, CUBE_FACES, 1.0
        elif kind == "mesh" and "procgen" in info:
            p = info["procgen"]
            if p["kind"] != "terrain":
                raise ValueError(f"procgen kind {p['kind']!r}: not a benchmark mesh")
            v, f = terrain(int(p["res"]), float(p["roughness"]), int(p["seed"]))
            sign = 1.0
        else:
            raise ValueError(f"primitive {kind!r}: not a benchmark primitive")
        m = transform_matrix(info.get("transform", {}))
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
        ior=np.full(len(mats), 1.5, np.float32),
        roughness=np.zeros(len(mats), np.float32),
        light_faces=np.stack([np.pad(x, (0, f_max - x.shape[0]), mode="edge")
                              for x in lights]),
        light_nfaces=np.array([x.shape[0] for x in lights], np.int32),
    )
    cam = scene["camera"]
    tf = cam["transform"]
    camera = dict(
        iview=np.linalg.inv(look_at_rowvec(tf["position"], tf["look_at"], tf["up"]))
        .astype(np.float32),
        fov_deg=np.float32(cam.get("fov", 90.0)),
        focal_dist=np.float32(cam.get("focal_dist", 1.0)),
        aperture=np.float32(cam.get("aperture", 0.0)),
        resolution=tuple(int(x) for x in cam["resolution"]),
    )
    return arrays, camera
