"""Inverse rendering end to end: recover a wall's albedo from a target image.

Counterpart of the JAX package's examples/invrender.py, with its flags and
defaults: render a target of the Cornell box ("reference" estimator, 3
bounces, seed 0), set the reddest material's albedo to grey and descend on
the pixels' mean squared error through the path tracer
(dist/render.train_step), the albedo alone: vertices and emission take
learning rate 0 and come back unchanged.

    python -m pyrenderer_tpu_torch.examples.invrender [--res 48] [--spp 4]
        [--steps 80] [--lr 30] [--cpu]

It runs on cuda:0 unless --cpu is given; with no GPU and no --cpu it exits
2. It exits 1 when the loss does not fall 10x.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.dist.render import pixel_grid, render_field, train_step
from pyrenderer_tpu_torch.scene import load_tungsten, to_device

SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "scenes", "cornell_box.json")


def recover(device, res=48, spp=4, steps=80, lr=30.0, log=print):
    """Run the recovery on `device` in float32. Returns a dict: the wall's
    material id, its true and recovered albedo (NumPy), the first and the
    last step's loss, the initial and the final params."""
    host, host_cam, _ = load_tungsten(SCENE)
    scene, camera = to_device(host, host_cam._replace(resolution=(res, res)), device)
    cfg = RenderConfig(max_bounces=3, spp=spp, seed=0, estimator="reference")
    px, py = pixel_grid(camera)
    with torch.no_grad():
        target = render_field(scene, camera, cfg, px, py)

    alb = host.albedo
    wall = int(np.argmax(alb[:, 0] - alb[:, 1]))  # the reddest material
    alb_init = alb.copy()
    alb_init[wall] = [0.5, 0.5, 0.5]
    params0 = (scene.vertices, torch.as_tensor(alb_init, device=scene.albedo.device),
               scene.emission)
    log(f"optimizing albedo of material {wall} (true {alb[wall].round(3)}) on {device}")
    params, loss0, loss = params0, None, None
    for step in range(steps):
        loss, params = train_step(params, scene, camera, cfg, target, px, py, (0.0, lr, 0.0))
        loss = float(loss)
        if loss0 is None:
            loss0 = loss
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step:3d}  loss {loss:.3e}  "
                f"albedo {params[1][wall].cpu().numpy().round(3)}")
    return {"wall": wall, "true_albedo": alb[wall].copy(),
            "albedo": params[1][wall].cpu().numpy(), "loss0": loss0, "loss": loss,
            "params0": params0, "params": params}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pyrenderer_tpu_torch.examples.invrender")
    p.add_argument("--res", type=int, default=48)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--lr", type=float, default=30.0, help="albedo learning rate")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda:0")
    else:
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    out = recover(device, args.res, args.spp, args.steps, args.lr)
    loss0, loss = out["loss0"], out["loss"]
    err = float(np.abs(out["albedo"] - out["true_albedo"]).max())
    print(f"done: loss {loss0:.3e} -> {loss:.3e} ({loss0 / max(loss, 1e-30):.1f}x), "
          f"albedo max err {err:.4f}")
    return 0 if loss < loss0 / 10 else 1


if __name__ == "__main__":
    sys.exit(main())
