"""Load-time structural checks on a host Scene (the JAX-free part of
pyrenderer_tpu/utils/checks.py)."""

from __future__ import annotations

import numpy as np


def validate_scene(scene) -> None:
    """Structural invariants on a Scene (load-time gate)."""
    v = np.asarray(scene.vertices)
    f = np.asarray(scene.faces)
    if not np.isfinite(v).all():
        raise ValueError("scene vertices contain non-finite values")
    if f.min() < 0 or f.max() >= v.shape[0]:
        raise ValueError("face indices out of range")
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    if (area <= 0).any():
        raise ValueError(f"{int((area <= 0).sum())} degenerate (zero-area) faces")
    mats = np.asarray(scene.face_material)
    if mats.max() >= scene.albedo.shape[0]:
        raise ValueError("face material index out of range")
    lf = np.asarray(scene.light_faces)
    if lf.max() >= f.shape[0]:
        raise ValueError("light face index out of range")
