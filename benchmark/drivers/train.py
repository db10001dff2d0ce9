"""The inverse-rendering driver: dist/render.train_step back to back, each
step from the parameters of the one before.

Set-up loads the configuration's scene (benchmark/reference/scene.py) on
the device, renders the target once with the reddest albedo made grey
(render_field under no_grad, the run's seed), and takes the traffic's
`checked_steps` first steps through the window's own call: train_step on
(vertices, albedo, emission) at the mix's rates, step k rendered with seed
`--seed` + k, so no two steps render the same samples. The window goes on
from those parameters until `seconds` have gone by, reading each step's
loss back; with a tracer, `profile_steps` steps after them are profiled
on the device alone, and one more with the host's operations.

What is judged is the checked steps against the plain reference's, from
the same parameters and seeds (benchmark/reference/train.py): each step's
loss, the first gradient as the program's SGD took it, and the
parameters' change over the checked steps.

The traffic mix's numbers: lr (vertices, albedo, emission), spp,
checked_steps, profile_steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare
from benchmark.reference import render as reference
from benchmark.reference import scene as scene_data
from benchmark.reference import train as ref_train

_U32 = 0xFFFFFFFF


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.traffic, self.config = cell.traffic, cell.config
        self.lr = tuple(float(x) for x in self.traffic["lr"])
        self.attempted = self.failed = 0
        self.step_s = []
        self.profiled = 0
        self.window_s = 0.0

    def _cfg(self, k: int):
        return self.cfg.replace(seed=(self.seed + k) & _U32 if k else self.seed)

    def _step(self, k: int):
        from pyrenderer_tpu_torch.dist.render import train_step

        loss, self.params = train_step(self.params, self.scene, self.cam, self._cfg(k),
                                       self.target, self.px, self.py, self.lr)
        return float(loss)

    def setup(self) -> None:
        from pyrenderer_tpu_torch.config import RenderConfig
        from pyrenderer_tpu_torch.dist.render import pixel_grid, render_field
        from pyrenderer_tpu_torch.scene.types import Camera, Scene, to_device

        c = self.config
        arrays, camera = scene_data.load(c["scene"])
        camera["resolution"] = tuple(c["resolution"])
        self.arrays, self.camera = arrays, camera
        self.scene, self.cam = to_device(Scene(**arrays), Camera(**camera), self.device)
        self.cfg = RenderConfig(max_bounces=int(c["max_bounces"]), spp=int(self.traffic["spp"]),
                                estimator=c["estimator"], seed=self.seed, **c["render"])
        self.px, self.py = pixel_grid(self.cam)
        grey = torch.as_tensor(ref_train.grey_albedo(arrays["albedo"]), device=self.device)
        with torch.no_grad():
            self.target = render_field(self.scene._replace(albedo=grey), self.cam, self.cfg,
                                       self.px, self.py)
        self.params = (self.scene.vertices, self.scene.albedo, self.scene.emission)
        host = lambda ps: [p.detach().cpu().numpy() for p in ps]  # noqa: E731
        first = host(self.params)
        self.losses = []
        for k in range(1, int(self.traffic["checked_steps"]) + 1):
            self.losses.append(self._step(k))
            if k == 1:
                after_one = host(self.params)
        self.checked = [first, after_one, host(self.params)]
        self.steps = int(self.traffic["checked_steps"])

    def window(self, seconds: float, tracer=None) -> None:
        """Steps until `seconds` have gone by. With a tracer, profile_steps
        more steps are then profiled on the device alone, and one more with
        the host's operations too (the breakdown's)."""
        t0 = time.perf_counter()

        def step():
            t = time.perf_counter()
            self._step(self.steps + len(self.step_s) + 1)
            self.step_s.append(time.perf_counter() - t)

        while time.perf_counter() - t0 < seconds or not self.step_s:
            step()
        if tracer is not None:
            n = int(self.traffic["profile_steps"])
            tracer.counters["unit_wall_s"] = float(np.median(self.step_s))
            tracer.begin()
            for _ in range(n):
                step()
            tracer.end(n)
            tracer.begin(host=True)
            step()
            tracer.end()
            self.profiled = n + 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - t0
        self.attempted = len(self.step_s)

    def summary(self) -> list:
        all_ms = np.asarray(self.step_s) * 1e3
        ms = all_ms[:all_ms.size - self.profiled]
        w, h = self.camera["resolution"]
        lines = [f"window: {all_ms.size} steps in {self.window_s:.3f} s, {w}x{h}; unprofiled "
                 f"step ms median {np.median(ms):.3f} min {ms.min():.3f} max {ms.max():.3f}; "
                 f"checked losses {self.losses}"]
        if self.profiled:
            lines.append("profiled step ms: " + " ".join(f"{x:.3f}" for x in all_ms[ms.size:]))
        return lines

    def end_to_end(self) -> dict:
        return {"step_ms": self.window_s * 1e3 / len(self.step_s)}

    def free(self) -> None:
        self.scene = self.cam = self.target = self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> dict:
        return compare.train_numbers({"losses": self.losses, "params": self.checked},
                                     reference_steps(self.cell, self.seed, self.device), self.lr)


def reference_steps(cell, seed: int, device, dtype=torch.float32, keep=None) -> dict:
    """The reference's checked steps of a run of `seed`: losses, first
    gradients and (params before, after one step, after the last), on the
    host. `dtype` below float32 makes the control; `keep` plants the
    half-batch fault."""
    c, traffic = cell.config, cell.traffic
    arrays, camera = scene_data.load(c["scene"])
    camera["resolution"] = tuple(c["resolution"])
    ref = reference.Reference(arrays, camera, c, device, dtype=dtype)
    w, h = camera["resolution"]
    px, py = ref_train.pixel_grid(w, h, device)
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)  # noqa: E731
    ref.set_params(as_t(arrays["vertices"]), as_t(ref_train.grey_albedo(arrays["albedo"])))
    with torch.no_grad():
        target = ref_train.render(ref, seed, px, py)
    params = tuple(as_t(arrays[k]) for k in ("vertices", "albedo", "emission"))
    n = int(traffic["checked_steps"])
    seeds = [(seed + k) & _U32 for k in range(1, n + 1)]
    lr = tuple(float(x) for x in traffic["lr"])
    losses, first, history = ref_train.steps(ref, params, target, seeds, lr, px, py, keep)
    host = lambda ps: [p.detach().float().cpu().numpy() for p in ps]  # noqa: E731
    return {"losses": losses, "grads": host(first),
            "params": [host(params), host(history[0]), host(history[-1])]}


def control_numbers(cell, seed: int, device, variant: str, samples=None) -> dict:
    """The comparison's numbers of the reference put in the program's place
    with `variant`: "bfloat16" (the control: one precision below the
    configuration's float32), "half_batch" (each chunk's second half of
    pixels left out, the mean taken over the rest) or "altered" (the loss
    read 1% high where it is produced), against the reference."""
    exact = reference_steps(cell, seed, device)
    if variant == "bfloat16":
        got = reference_steps(cell, seed, device, dtype=torch.bfloat16)
    elif variant == "half_batch":
        def keep(sl):
            n = min(sl.stop, int(np.prod(cell.config["resolution"]))) - sl.start
            mask = torch.zeros(n, dtype=torch.bool, device=device)
            mask[: n // 2] = True
            return mask
        got = reference_steps(cell, seed, device, keep=keep)
    elif variant == "altered":
        got = dict(exact, losses=[x * 1.01 for x in exact["losses"]])
    else:
        raise ValueError(f"variant {variant!r}")
    lr = tuple(float(x) for x in cell.traffic["lr"])
    return compare.train_numbers(got, exact, lr)
