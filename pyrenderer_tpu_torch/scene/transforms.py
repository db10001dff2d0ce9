"""Host-side affine transforms and camera matrices (NumPy, build time only).

Reproduces the *semantics* of the reference's transform stack without its
scipy/pyrr dependencies:

- Tungsten TRS composition T @ R @ S with per-axis Euler rotations applied
  in x, y, z order, each as ``R = R @ axis_rot`` (reference
  mathematics/affine_transformation.py:7-55).
- Row-vector look-at view matrix matching ``pyrr.matrix44.create_look_at``
  (reference core/camera.py:18), i.e. ``v_row @ M`` convention.

Note: like the reference, points transform as column vectors ``M @ p`` for
the TRS matrix, but as row vectors ``p @ M`` for the camera matrices.
"""

from __future__ import annotations

from math import radians

import numpy as np


def _axis_rotation(axis: int, degrees: float) -> np.ndarray:
    """3x3 active rotation about x/y/z, matching scipy Rotation.from_euler."""
    a = radians(degrees)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(3)
    if axis == 0:
        m = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    elif axis == 1:
        m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    else:
        m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return m


def make_rotation_matrix(degrees) -> np.ndarray:
    """4x4 rotation from per-axis degrees, composed as R = R @ rot(axis)
    for each nonzero axis in x, y, z order (reference
    affine_transformation.py:7-14)."""
    rot = np.eye(3)
    for axis, deg in enumerate(degrees):
        if deg != 0:
            rot = rot @ _axis_rotation(axis, deg)
    out = np.eye(4)
    out[:3, :3] = rot
    return out


def make_translation_matrix(moves) -> np.ndarray:
    out = np.eye(4)
    out[:3, 3] = moves
    return out


def make_scale_matrix(scales) -> np.ndarray:
    out = np.eye(4)
    out[0, 0], out[1, 1], out[2, 2] = scales
    return out


def make_transformation_matrix(transforms: dict) -> np.ndarray:
    """Tungsten transform dict → 4x4, composed position @ rotation @ scale
    (reference affine_transformation.py:39-55)."""
    out = np.eye(4)
    if "position" in transforms:
        out = out @ make_translation_matrix(transforms["position"])
    if "rotation" in transforms:
        out = out @ make_rotation_matrix(transforms["rotation"])
    if "scale" in transforms:
        out = out @ make_scale_matrix(transforms["scale"])
    return out


def look_at_rowvec(eye, target, up) -> np.ndarray:
    """Row-vector-convention view matrix (pyrr.matrix44.create_look_at
    semantics, used at reference core/camera.py:18)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
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


def apply_transform(mat4: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Column-vector transform of (N, 3) points by a 4x4 matrix (what
    trimesh.apply_transform does at reference shapes.py:35)."""
    homo = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)
    return (mat4 @ homo.T).T[:, :3]
