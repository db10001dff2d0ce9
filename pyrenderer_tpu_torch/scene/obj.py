"""Minimal Wavefront .obj loader (triangulating).

The reference ships media/cube.obj but has no .obj reader at all (SURVEY
§2: grep finds no loader; the file is dead data). BASELINE config 2 renders
an .obj mesh, so this provides: v / f parsing, 1-based and negative
indices, v/vt/vn slash syntax, polygon fan triangulation. Normals are
geometric per-face (computed downstream from winding), matching how the
rest of the pipeline treats meshes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def parse_obj(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vertices (V, 3) float64, faces (T, 3) int32)."""
    vertices = []
    faces = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "v" and len(parts) >= 4:
            vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif parts[0] == "f" and len(parts) >= 4:
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(vertices) + i)
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    if not vertices or not faces:
        raise ValueError("obj contains no geometry")
    return np.asarray(vertices, np.float64), np.asarray(faces, np.int32)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        return parse_obj(f.read())
