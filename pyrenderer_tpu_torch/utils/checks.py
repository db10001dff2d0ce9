"""Numerical and structural checks. Counterpart of pyrenderer_tpu/utils/checks.py:
`assert_all_finite` (run_resilient's guard in render/driver.py) and the
load-time `validate_scene`."""

from __future__ import annotations

import numpy as np
import torch


def leaves_with_path(tree, path: str = ""):
    """(path, leaf) for every leaf of a nested structure, the path written
    as jax.tree_util.keystr writes it: [0] for a sequence index, ['k'] for
    a dict key, .name for a NamedTuple field."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from leaves_with_path(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_all_finite(tree, where: str = "") -> None:
    """Host-side finite check over a nested structure of tensors and
    arrays; raises FloatingPointError naming the first bad leaf's path."""
    for path, leaf in leaves_with_path(tree):
        arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(f"{bad} non-finite values in {path} {where}")


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

