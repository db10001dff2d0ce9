"""pyrenderer_tpu_torch scene loading against the JAX package's loader."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pyrenderer_tpu.scene.tungsten import load_tungsten as load_jax
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.scene import load_tungsten, to_device
from pyrenderer_tpu_torch.scene.types import scene_to_numpy

SCENES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scenes")


@pytest.mark.parametrize("name", ["cornell_box", "cornell_mesh", "cube_mesh", "spheres"])
def test_scene_loads_equal(name):
    """Every Scene and Camera array and the RenderConfig are exactly equal."""
    path = os.path.join(SCENES, f"{name}.json")
    scene_j, cam_j, cfg_j = load_jax(path)
    scene_t, cam_t, cfg_t = load_tungsten(path)
    assert scene_t._fields == scene_j._fields
    for field, a, b in zip(scene_j._fields, scene_j, scene_t):
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    assert cam_t.resolution == cam_j.resolution
    for field in ("iview", "fov_deg", "focal_dist", "aperture"):
        a, b = getattr(cam_j, field), getattr(cam_t, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert isinstance(cfg_t, RenderConfig)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_to_device_round_trip(dtype):
    """to_device carries the JAX loader's host arrays unchanged."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    scene, camera, _ = load_jax(os.path.join(SCENES, "cornell_box.json"), dtype=np_dtype)
    scene_t, cam_t = to_device(scene, camera, "cpu", dtype)
    assert scene_t.vertices.dtype == dtype and scene_t.faces.dtype == torch.int64
    back = scene_to_numpy(scene_t)
    for field, a, b in zip(scene._fields, scene, back):
        assert np.array_equal(a, b), field
    assert np.array_equal(cam_t.iview.numpy(), camera.iview)
    assert cam_t.fov_deg.dim() == 0 and float(cam_t.fov_deg) == float(camera.fov_deg)
    assert cam_t.resolution == camera.resolution


def test_loader_errors():
    """Load-time gates: no lights and unknown bsdf types raise."""
    from pyrenderer_tpu_torch.scene.tungsten import build_scene

    base = {"camera": {"transform": {"position": [0, 0, 5], "look_at": [0, 0, 0],
                                     "up": [0, 1, 0]}, "resolution": [8, 8]},
            "bsdfs": [{"name": "w", "type": "lambert", "albedo": 0.5}],
            "primitives": [{"type": "quad", "bsdf": "w"}]}
    with pytest.raises(ValueError, match="no lights"):
        build_scene(base)
    bad = dict(base, bsdfs=[{"name": "w", "type": "velvet"}])
    with pytest.raises(NotImplementedError):
        build_scene(bad)
