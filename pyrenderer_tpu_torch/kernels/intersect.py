"""Whole-table closest-hit and any-hit queries: CUDA kernels and their twins.

Counterpart of pyrenderer_tpu/kernels/pallas_intersect.py. The kernels
(csrc/intersect.cu) replace the TPU's ``_closest_kernel`` and
``_anyhit_kernel``: every ray against every triangle of a (9, T) table
``[v0 | e1 | e2]``, one GPU thread per ray.

``closest_hit`` and ``occluded`` take the device from their tensors. For a
CUDA tensor they launch the kernel (or raise); for a CPU tensor they run
the plain PyTorch twins ``closest_hit_ref`` / ``occluded_ref``, the same
Moeller-Trumbore in the same operation order broadcast over (N, T). There
is no fallback from one to the other.

Both follow the TPU kernels' miss contract: tri = -1 and t = 0 (the brute
backend of core/intersect.py returns tri = 0 on a miss instead).

Each wrapper counts its kernel launches (``closest_hit.launches``) and, apart
from them, the calls it served with the twin (``closest_hit.twin_calls``),
so a run can show which path it took.
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.core.intersect import intersect_brute_arrays, occluded_arrays
from pyrenderer_tpu_torch.kernels import build


def pack_triangles(vertices, faces):
    """(9, T) float32 triangle table [v0 | e1 | e2], detached (the hit
    selection is discrete; callers re-derive hit geometry differentiably)."""
    vertices = vertices.detach()
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    return torch.cat([v0.T, e1.T, e2.T], dim=0).to(torch.float32).contiguous()


def _table_arrays(tri_table, dtype):
    t = tri_table.to(dtype)
    return t[0:3].T, t[3:6].T, t[6:9].T


def _detach(ro, rd, t1):
    return ro.detach(), rd.detach(), t1.detach() if torch.is_tensor(t1) else t1


def closest_hit_ref(tri_table, ro, rd, t0, t1):
    """Plain twin of the closest-hit kernel: (hit (N,) bool, t (N,), tri (N,)
    int32), tri = -1 and t = 0 on a miss, ties to the lowest face."""
    ro, rd, t1 = _detach(ro, rd, t1)
    hit, t, tri = intersect_brute_arrays(*_table_arrays(tri_table, ro.dtype), ro, rd, t0, t1)
    return hit, t, torch.where(hit, tri, -1)


def occluded_ref(tri_table, ro, rd, t0, t1):
    """Plain twin of the any-hit kernel: (N,) bool."""
    ro, rd, t1 = _detach(ro, rd, t1)
    return occluded_arrays(*_table_arrays(tri_table, ro.dtype), ro, rd, t0, t1)


def _check_cuda_args(tri_table, ro, rd, t1):
    """Validate the kernel operands; return (t1 tensor or None, t1 scalar)."""
    dev = ro.device
    for name, x in (("tri_table", tri_table), ("ro", ro), ("rd", rd)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = ro.shape[0]
    if ro.dim() != 2 or ro.shape[1] != 3 or rd.shape != ro.shape:
        raise ValueError(f"ro and rd must both be (N, 3), got {tuple(ro.shape)}"
                         f" and {tuple(rd.shape)}")
    if tri_table.dim() != 2 or tri_table.shape[0] != 9:
        raise ValueError(f"tri_table must be (9, T), got {tuple(tri_table.shape)}")
    if not torch.is_tensor(t1) or t1.dim() == 0:
        return None, float(t1)
    if (t1.shape != (n,) or t1.device != dev or t1.dtype != torch.float32
            or not t1.is_contiguous()):
        raise ValueError("per-ray t1 must be a contiguous float32 (N,) tensor "
                         f"on {dev}, got {t1.dtype} {tuple(t1.shape)} on {t1.device}")
    return t1, 0.0


def closest_hit(tri_table, ro, rd, t0, t1):
    """Closest hit of rays ro, rd (N, 3) against the (9, T) table within
    (t0, t1), t1 a scalar or (N,). Returns (hit bool, t f32, tri int32),
    each (N,); tri = -1 and t = 0 on a miss."""
    if ro.device.type == "cpu":
        closest_hit.twin_calls += 1
        return closest_hit_ref(tri_table, ro, rd, t0, t1)
    if ro.device.type != "cuda":
        raise ValueError(f"closest_hit: no kernel for device {ro.device}")
    ro, rd, t1 = _detach(ro, rd, t1)
    t1v, t1s = _check_cuda_args(tri_table, ro, rd, t1)
    n = ro.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=ro.device)
    tri_out = torch.empty(n, dtype=torch.int32, device=ro.device)
    hit_out = torch.empty(n, dtype=torch.bool, device=ro.device)
    with torch.cuda.device(ro.device):
        lib, stream = build.launch_context(ro.device)
        err = lib.pr_closest_hit(
            tri_table.data_ptr(), tri_table.shape[1], ro.data_ptr(),
            rd.data_ptr(), None if t1v is None else t1v.data_ptr(), t1s,
            float(t0), n, t_out.data_ptr(), tri_out.data_ptr(),
            hit_out.data_ptr(), stream)
    build.check_launch(err, "closest_hit")
    closest_hit.launches += 1
    return hit_out, t_out, tri_out


def occluded(tri_table, ro, rd, t0, t1):
    """Any-hit shadow query (same operands as closest_hit): (N,) bool."""
    if ro.device.type == "cpu":
        occluded.twin_calls += 1
        return occluded_ref(tri_table, ro, rd, t0, t1)
    if ro.device.type != "cuda":
        raise ValueError(f"occluded: no kernel for device {ro.device}")
    ro, rd, t1 = _detach(ro, rd, t1)
    t1v, t1s = _check_cuda_args(tri_table, ro, rd, t1)
    n = ro.shape[0]
    hit_out = torch.empty(n, dtype=torch.bool, device=ro.device)
    with torch.cuda.device(ro.device):
        lib, stream = build.launch_context(ro.device)
        err = lib.pr_occluded(
            tri_table.data_ptr(), tri_table.shape[1], ro.data_ptr(),
            rd.data_ptr(), None if t1v is None else t1v.data_ptr(), t1s,
            float(t0), n, hit_out.data_ptr(), stream)
    build.check_launch(err, "occluded")
    occluded.launches += 1
    return hit_out


def reset_counters() -> None:
    for fn in (closest_hit, occluded):
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()
