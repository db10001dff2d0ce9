"""Multi-process render worker: ``python -m pyrenderer_tpu_torch.dist.worker
scene.json ...``.

Counterpart of pyrenderer_tpu/dist/worker.py. One OS process per rank:
launch one per GPU with --coordinator <host0:port> (or an init_method URL
such as file:///tmp/pg) --num-processes N --process-id i. Without --cpu a
rank runs on cuda:{local rank % GPUs} and the ranks meet over NCCL, one
rank per GPU; ranks that share a GPU take --backend gloo (their kernels
still run on the card, the collectives pass through host memory). --cpu
puts every rank on the CPU over gloo, one CPU device per process (where
the JAX worker's --cpu-devices K gives a process K virtual devices).

Every rank runs the same program; process 0 writes the assembled HDR
image (--out, .npy) and every rank prints one JSON line prefixed "RESULT "
for harnesses to scrape: the JAX worker's keys (global_devices is the
world size), the rank's device, and its kernel wrappers' launches and
twin calls over the rendered frames (kernels.counts()).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pyrenderer_tpu_torch.dist.worker")
    p.add_argument("scene", help="Tungsten scene JSON path")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0, or an init_method URL")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run this rank on the CPU (gloo), not on the GPU")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend (default: nccl on GPUs, gloo with --cpu)")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sp", type=int, default=1, help="spp mesh-axis size")
    p.add_argument("--reps", type=int, default=1, help="timed repetitions")
    p.add_argument("--out", default=None, help="process 0 writes HDR .npy here")
    p.add_argument("--train-steps", type=int, default=0,
                   help="also run N inverse-rendering train steps over the mesh "
                        "(the gradient all-reduce crosses processes); RESULT gains "
                        "train_losses and the gradient statistics")
    args = p.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run the ranks on the CPU", file=sys.stderr)
        return 2

    import numpy as np
    import torch.distributed as dist

    from pyrenderer_tpu_torch import kernels
    from pyrenderer_tpu_torch.dist import multihost
    from pyrenderer_tpu_torch.dist.render import loss_and_grads, pixel_grid, train_step
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device

    multi = multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                                 backend=args.backend, device="cpu" if args.cpu else None)
    try:
        device = multihost.rank_device(cpu=args.cpu)
        pid = dist.get_rank()

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        host, camera, cfg = load_tungsten(args.scene)
        camera = camera._replace(resolution=(args.res, args.res))
        cfg = cfg.replace(spp=args.spp, max_bounces=args.depth, seed=args.seed,
                          estimator="reference", resolution=None)
        scene, camera = to_device(host, camera, device)
        mesh = multihost.make_host_mesh(sp=args.sp)

        kernels.reset_counters()
        img = multihost.render_image_multihost(scene, camera, cfg, mesh)  # warmup
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            img = multihost.render_image_multihost(scene, camera, cfg, mesh)
        sync()
        dt = (time.perf_counter() - t0) / args.reps
        launches, twins = kernels.counts()

        px, py = multihost._global_pixel_arrays(camera, mesh)
        n_rays = multihost._count_rays(scene, camera, cfg, mesh, px, py) * cfg.spp

        result = {
            "process_id": pid,
            "num_processes": dist.get_world_size(),
            "global_devices": dist.get_world_size(),
            "multi": multi,
            "time_s": dt,
            "mrays_per_s": n_rays / dt / 1e6,
            "image_mean": float(img.mean()),
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu"),
            "backend": dist.get_backend(),
            "launches": launches,
            "twin_calls": twins,
        }

        if args.train_steps > 0:
            # inverse-rendering steps over the same mesh: the parameter
            # gradients are all-reduced over every rank, across processes
            params = (scene.vertices, scene.albedo, scene.emission)
            all_x, all_y = pixel_grid(camera)
            target = torch.zeros((all_x.shape[0], 3), dtype=scene.vertices.dtype,
                                 device=device)
            losses = []
            for _ in range(args.train_steps):
                loss, params = train_step(params, scene, camera, cfg, target, all_x, all_y,
                                          1e-3, mesh=mesh)
                losses.append(float(loss))
            # the true gradients at the final params (recovering them from
            # the float32 SGD delta would round small gradients of large
            # values, such as the emission's, to zero)
            _, grads = loss_and_grads(params, scene, camera, cfg, target, all_x, all_y,
                                      mesh=mesh)
            result["train_losses"] = losses
            result["grad_mean_abs"] = [float(g.abs().mean()) for g in grads]
            result["param_mean_abs"] = [float(q.abs().mean()) for q in params]

        if pid == 0 and args.out:
            np.save(args.out, img)
        print("RESULT " + json.dumps(result), flush=True)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
