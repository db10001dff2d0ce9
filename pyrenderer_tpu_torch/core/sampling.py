"""Batched sampling primitives (PyTorch).

Counterpart of pyrenderer_tpu/core/sampling.py; the algorithms mirror the
reference renderer so images line up:
  - PBRT concentric-disk -> cosine-hemisphere (reference
    mathematics/samplers.py:10-32);
  - "rotate z to normal" shading frame (reference mathematics/
    mat4_taichi.py:9-60), with its special cases for n ~ +-y_hat;
  - sqrt-barycentric uniform area sampling (reference shapes.py:63-71).

Vectors are (..., 3) tensors. The square roots and normalisations use
double-``where`` guards so that neither value nor gradient is NaN at 0.
"""

from __future__ import annotations

import torch

PI = 3.141592653589793
INV_PI = 1.0 / PI
_AXIS_EPS = 1e-6


def safe_sqrt(x):
    """sqrt with a NaN-free backward at x <= 0: guard the operand, not just
    the result (where(c, 0, sqrt(x)) still propagates inf*0 = NaN)."""
    nonpos = x <= 0
    return torch.where(nonpos, 0.0, torch.sqrt(torch.where(nonpos, 1.0, x)))


def safe_normalize(v):
    """v / |v| with NaN-free value AND gradient at |v| == 0 (0 there)."""
    ss = torch.sum(v * v, dim=-1, keepdim=True)
    zero = ss == 0
    inv = 1.0 / torch.sqrt(torch.where(zero, 1.0, ss))
    return v * torch.where(zero, 0.0, inv)


def concentric_sample_disk(u1, u2):
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    safe_ox = torch.where(ox == 0, 1.0, ox)
    safe_oy = torch.where(oy == 0, 1.0, oy)
    theta = torch.where(
        use_x,
        (PI / 4) * (oy / safe_ox),
        (PI / 2) - (PI / 4) * (ox / safe_oy),
    )
    zero = (ox == 0) & (oy == 0)
    dx = torch.where(zero, 0.0, r * torch.cos(theta))
    dy = torch.where(zero, 0.0, r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1, u2):
    """Local-frame direction with z up; pdf = z / pi."""
    dx, dy = concentric_sample_disk(u1, u2)
    z = safe_sqrt(1.0 - dx * dx - dy * dy)
    return torch.stack([dx, dy, z], dim=-1)


def _axis(n, k):
    """Unit basis vector k, broadcast to n's shape."""
    e = torch.zeros(3, dtype=n.dtype, device=n.device)
    e[k] = 1.0
    return e.expand_as(n)


def make_frame(n):
    """Shading frame (x_hat, z_hat) completing unit normal n (..., 3),
    reference mat4_taichi.py:9-47 semantics."""
    ny = n[..., 1]
    axis = ((ny - 1.0).abs() < _AXIS_EPS) | ((ny + 1.0).abs() < _AXIS_EPS)
    # general branch: x = normalize(cross(n, y_hat)) = normalize((-nz, 0, nx))
    gx = safe_normalize(torch.stack([-n[..., 2], torch.zeros_like(ny), n[..., 0]], dim=-1))
    gz = safe_normalize(torch.linalg.cross(gx, n, dim=-1))
    x_hat = torch.where(axis[..., None], _axis(n, 0), gx)
    z_hat = torch.where(axis[..., None], _axis(n, 2), gz)
    return x_hat, z_hat


def rotate_z_to(n, local):
    """Map a local (z-up) direction into the frame of normal n and normalize
    (reference mat4_taichi.py:45-60). For n ~ -y_hat the reference's frame
    maps local z to -y (its rotate_to flips only the y row); reproduced."""
    ny = n[..., 1]
    neg_y = (ny + 1.0).abs() < _AXIS_EPS
    pos_y = (ny - 1.0).abs() < _AXIS_EPS
    ey = _axis(n, 1)
    n_frame = torch.where(pos_y[..., None], ey, torch.where(neg_y[..., None], -ey, n))
    x_hat, z_hat = make_frame(n)
    world = (
        local[..., 0:1] * x_hat
        + local[..., 1:2] * z_hat
        + local[..., 2:3] * n_frame
    )
    return safe_normalize(world)


def sample_triangle_point(v0, v1, v2, u, v):
    """sqrt-barycentric uniform area sample (reference shapes.py:63-71):
    a = sqrt(u)(1-v), b = sqrt(u)v, p = a*v0 + b*v1 + (1-a-b)*v2."""
    su = torch.sqrt(u)
    a = (su * (1.0 - v))[..., None]
    b = (su * v)[..., None]
    return a * v0 + b * v1 + (1.0 - a - b) * v2
