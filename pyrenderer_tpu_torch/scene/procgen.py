"""Deterministic procedural meshes for large-scene tests and benchmarks.

Counterpart of pyrenderer_tpu/scene/procgen.py (NumPy, copied):

  - `terrain(res)` -- fractal midpoint-displacement heightfield,
    2 * res^2 triangles (res=224 -> 100,352);
  - `blob(subdivisions)` -- icosphere displaced by low-frequency ridges,
    20 * 4^n triangles (n=6 -> 81,920; n=7 -> 327,680);
  - `big_scene_data(...)` -- a Tungsten-style scene dict: the Cornell box
    walls and light with the procedural mesh inside, loadable through
    scene/tungsten.py build_scene.

Everything is seeded (np.random.default_rng with fixed seeds), so the
arrays equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np

from pyrenderer_tpu_torch.scene.geometry import icosphere


def terrain(res: int = 224, roughness: float = 0.55, seed: int = 7):
    """Fractal heightfield on a (res+1)^2 grid -> (verts, faces), 2*res^2 tris.

    Midpoint-displacement built by coarse-to-fine upsampling: start 2x2,
    double resolution each octave (bilinear), add scaled noise.
    """
    rng = np.random.default_rng(seed)
    size = 2
    h = rng.standard_normal((size, size))
    amp = 1.0
    while size <= res:
        new = np.empty((2 * size - 1, 2 * size - 1))
        new[::2, ::2] = h
        new[1::2, ::2] = 0.5 * (h[:-1, :] + h[1:, :])
        new[::2, 1::2] = 0.5 * (h[:, :-1] + h[:, 1:])
        new[1::2, 1::2] = 0.25 * (
            h[:-1, :-1] + h[1:, :-1] + h[:-1, 1:] + h[1:, 1:]
        )
        amp *= roughness
        new += amp * rng.standard_normal(new.shape)
        h = new
        size = h.shape[0]
    h = h[: res + 1, : res + 1]
    h = (h - h.min()) / max(h.max() - h.min(), 1e-9)  # [0, 1]

    ys, xs = np.mgrid[0 : res + 1, 0 : res + 1] / res  # [0, 1]^2
    verts = np.stack(
        [xs.ravel() - 0.5, 0.35 * h.ravel(), ys.ravel() - 0.5], axis=1
    )
    i = (np.arange(res)[:, None] * (res + 1) + np.arange(res)[None, :]).ravel()
    quad = np.stack([i, i + 1, i + res + 2, i, i + res + 2, i + res + 1], axis=1)
    faces = quad.reshape(-1, 3).astype(np.int32)
    return verts, faces


def blob(subdivisions: int = 6, seed: int = 11):
    """Icosphere displaced by ridged sinusoidal noise -> (verts, faces)."""
    verts, faces = icosphere(subdivisions)
    verts = np.asarray(verts, np.float64)
    rng = np.random.default_rng(seed)
    disp = np.zeros(len(verts))
    for freq, amp in ((2.1, 0.20), (4.7, 0.10), (9.3, 0.05)):
        k = rng.standard_normal((3, 3))
        phase = rng.uniform(0, 2 * np.pi, 3)
        disp += amp * np.abs(
            np.sin(verts @ (freq * k[0]) + phase[0])
            * np.sin(verts @ (freq * k[1]) + phase[1])
        )
    verts = verts * (1.0 + disp)[:, None] * 0.5
    return verts, np.asarray(faces, np.int32)


def big_scene_data(kind: str = "terrain", **kw) -> dict:
    """Tungsten-style dict: Cornell walls + light + a procedural mesh.

    The mesh is passed in-memory ("vertices"/"faces" on the primitive --
    scene/tungsten.py accepts either that or an .obj "file").
    """
    if kind == "terrain":
        verts, faces = terrain(**kw)
        mesh_tf = {"position": [0, 0.02, 0], "scale": [1.9, 1.0, 1.9]}
    elif kind == "blob":
        verts, faces = blob(**kw)
        mesh_tf = {"position": [0, 0.8, 0], "scale": [0.8, 0.8, 0.8]}
    else:
        raise ValueError(f"unknown procedural mesh kind: {kind}")
    return {
        "bsdfs": [
            {"name": "LeftWall", "albedo": [0.63, 0.065, 0.05], "type": "lambert"},
            {"name": "RightWall", "albedo": [0.14, 0.45, 0.091], "type": "lambert"},
            {"name": "Walls", "albedo": [0.725, 0.71, 0.68], "type": "lambert"},
            {"name": "Mesh", "albedo": [0.55, 0.48, 0.4], "type": "lambert"},
            {"name": "Light", "albedo": 1, "type": "null"},
        ],
        "primitives": [
            {"type": "quad", "bsdf": "Walls",
             "transform": {"scale": [2, 4, 2], "rotation": [0, 90, 0]}},
            {"type": "quad", "bsdf": "Walls",
             "transform": {"position": [0, 2, 0], "scale": [2, 4, 2],
                           "rotation": [0, 0, -180]}},
            {"type": "quad", "bsdf": "Walls",
             "transform": {"position": [0, 1, -1], "scale": [2, 4, 2],
                           "rotation": [0, 90, 90]}},
            {"type": "quad", "bsdf": "RightWall",
             "transform": {"position": [1, 1, 0], "scale": [2, 4, 2],
                           "rotation": [0, 180, 90]}},
            {"type": "quad", "bsdf": "LeftWall",
             "transform": {"position": [-1, 1, 0], "scale": [2, 4, 2],
                           "rotation": [0, 0, 90]}},
            {"type": "mesh", "bsdf": "Mesh", "vertices": verts, "faces": faces,
             "transform": mesh_tf},
            {"type": "quad", "bsdf": "Light", "emission": [17, 12, 4],
             "transform": {"position": [-0.005, 1.98, -0.03],
                           "scale": [0.47, 0.1786, 0.38],
                           "rotation": [0, 180, 180]}},
        ],
        "camera": {
            "type": "pinhole", "fov": 35.0, "resolution": [1024, 1024],
            "transform": {"position": [0, 1.2, 6.0], "look_at": [0, 0.5, 0],
                          "up": [0, 1, 0]},
        },
        "integrator": {"type": "path_tracer", "max_bounces": 4},
        "renderer": {"spp": 16},
    }
