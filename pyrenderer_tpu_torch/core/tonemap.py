"""Tone mapping operators (PyTorch). Counterpart of
pyrenderer_tpu/core/tonemap.py:
  - "sqrt": sqrt of mean radiance (reference main_taichi.py:61-64), NaNs
    mapped to 0 (tone_map.py:8);
  - "reinhard": extended Reinhard on luminance with the image's max
    luminance as white point (reference main_taichi.py:67-78);
  - "filmic": Hable/Uncharted-2 curve per channel, white-point normalized,
    then a 1/2.2 gamma (Tungsten's "filmic", scene.json:277).
"""

from __future__ import annotations

import torch

LUMA_WEIGHTS = (0.2126, 0.7152, 0.0722)


def tonemap_sqrt(hdr):
    """sqrt tonemap of mean radiance (reference main_taichi.py:63)."""
    hdr = torch.nan_to_num(hdr, nan=0.0)
    return torch.clamp(torch.sqrt(torch.clamp(hdr, min=0.0)), 0.0, 1.0)


def tonemap_reinhard_extended(hdr):
    """Luminance extended-Reinhard with max-luminance white point
    (reference main_taichi.py:67-78)."""
    hdr = torch.nan_to_num(hdr, nan=0.0)
    lum = (
        hdr[..., 0] * LUMA_WEIGHTS[0]
        + hdr[..., 1] * LUMA_WEIGHTS[1]
        + hdr[..., 2] * LUMA_WEIGHTS[2]
    )
    max_white = torch.clamp(lum.max(), min=1e-8)
    numerator = lum * (1.0 + lum / (max_white * max_white))
    l_new = numerator / (1.0 + lum)
    scale = torch.where(lum > 0, l_new / torch.where(lum == 0, 1.0, lum), 0.0)
    return torch.clamp(hdr * scale[..., None], 0.0, 1.0)


# Hable/Uncharted-2 constants (shoulder strength, linear strength/angle,
# toe strength/numerator/denominator) and the linear white point.
_HABLE_A, _HABLE_B, _HABLE_C = 0.15, 0.50, 0.10
_HABLE_D, _HABLE_E, _HABLE_F = 0.20, 0.02, 0.30
_HABLE_W = 11.2


def _hable(x):
    a, b, c, d, e, f = _HABLE_A, _HABLE_B, _HABLE_C, _HABLE_D, _HABLE_E, _HABLE_F
    return (x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f) - e / f


def tonemap_filmic(hdr, exposure: float = 2.0):
    """Hable filmic curve, per channel, + 1/2.2 gamma. Monotone increasing,
    maps 0 -> 0 and the white point W -> 1 before gamma."""
    hdr = torch.nan_to_num(hdr, nan=0.0)
    x = torch.clamp(hdr, min=0.0) * exposure
    white = torch.full((), _HABLE_W, dtype=hdr.dtype, device=hdr.device)
    mapped = _hable(x) / _hable(white)
    return torch.clamp(torch.pow(torch.clamp(mapped, min=0.0), 1.0 / 2.2), 0.0, 1.0)


def tonemap(hdr, mode: str):
    if mode == "sqrt":
        return tonemap_sqrt(hdr)
    if mode == "reinhard":
        return tonemap_reinhard_extended(hdr)
    if mode == "filmic":
        return tonemap_filmic(hdr)
    if mode == "none":
        return hdr
    raise ValueError(f"unknown tonemap mode {mode!r}")
