"""CLI: ``python -m pyrenderer_tpu_torch.render.cli scene.json [flags]``.

Counterpart of pyrenderer_tpu/render/cli.py, scene-file mode, with the same
flags and defaults. It renders on ``cuda:0`` unless ``--cpu`` is given; with
no GPU and no ``--cpu`` it exits non-zero, it never falls back to the CPU.

Like the JAX CLI it defaults to ``--estimator pbrt`` (core/integrator_pbrt.py);
``--estimator reference`` reproduces the reference renderer's tracer.
What is not ported raises NotImplementedError naming its ROADMAP item; the
JAX CLI's ``--resilient``, ``--live`` and ``--debug-paths`` flags do not
exist yet (ROADMAP A6, A12).
"""

from __future__ import annotations

import argparse
import sys

# scene-argument modes of the JAX CLI and the ROADMAP item that ports each
_NOT_PORTED_MODES = {"analytic": "A11", "tonemap": "A6"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pyrenderer_tpu_torch",
        description="Path tracer on PyTorch and CUDA",
    )
    p.add_argument(
        "scene",
        help="Tungsten scene JSON (the JAX CLI's 'analytic' and 'tonemap' "
        "modes are not ported yet)",
    )
    p.add_argument("--spp", type=int, help="samples per pixel (scene default)")
    p.add_argument("--spp-step", type=int, help="samples per progressive pass")
    p.add_argument("--depth", type=int, help="max bounces (scene default)")
    p.add_argument("--res", type=int, nargs=2, metavar=("W", "H"), help="override resolution")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--estimator", choices=["reference", "pbrt"], default="pbrt",
        help="radiance estimator (default: pbrt, physically based with MIS, "
        "Russian roulette, metal and glass; reference: the reference "
        "renderer's tracer)",
    )
    p.add_argument(
        "--tonemap", choices=["sqrt", "reinhard", "filmic", "none"],
        help="LDR operator",
    )
    p.add_argument("--out", help="output PNG path (scene default)")
    p.add_argument("--hdr-out", help="output EXR/NPY path")
    p.add_argument(
        "--backend",
        choices=["auto", "cuda", "brute", "pallas", "matmul", "bvh", "cluster",
                 "cluster_binned", "cluster_streamed", "cluster_chunked",
                 "watertight"],
        default="auto",
        help="intersection backend: auto = the whole-table CUDA kernels on a "
        "GPU (the plain PyTorch test on the CPU) up to 4096 triangles, above "
        "the cluster sweep on a GPU (the binned traversal under "
        "PYRENDERER_CLUSTER_IMPL=binned) and the BVH on the CPU; pallas and "
        "matmul are not ported and raise",
    )
    p.add_argument("--chunk", type=int, default=1 << 16,
                   help="rays per dispatch chunk (default 2^16)")
    p.add_argument("--preview-interval", type=int,
                   help="dump a tonemapped preview PNG every N passes")
    p.add_argument("--preview-file", help="preview PNG path (default preview.png)")
    p.add_argument("--checkpoint", help="checkpoint .npz path (enables save)")
    p.add_argument("--checkpoint-interval", type=int, help="passes between checkpoints")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU with the plain PyTorch versions")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.scene in _NOT_PORTED_MODES:
        raise NotImplementedError(
            f"the {args.scene!r} mode is not ported yet (ROADMAP {_NOT_PORTED_MODES[args.scene]})")

    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda:0")
    else:
        print("no CUDA device: pass --cpu to render on the CPU", file=sys.stderr)
        return 2

    from pyrenderer_tpu_torch.core.film import Film
    from pyrenderer_tpu_torch.render.driver import ProgressiveRenderer
    from pyrenderer_tpu_torch.scene import load_tungsten, to_device

    scene, camera, cfg = load_tungsten(args.scene)
    overrides = {"seed": args.seed, "estimator": args.estimator}
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.spp_step is not None:
        overrides["spp_step"] = args.spp_step
    if args.depth is not None:
        overrides["max_bounces"] = args.depth
    if args.res is not None:
        overrides["resolution"] = tuple(args.res)
    if args.tonemap is not None:
        overrides["tonemap"] = args.tonemap
    if args.out is not None:
        overrides["output_file"] = args.out
    if args.hdr_out is not None:
        overrides["hdr_output_file"] = args.hdr_out
    if args.checkpoint_interval is not None:
        overrides["checkpoint_interval"] = args.checkpoint_interval
    if args.preview_interval is not None:
        overrides["preview_interval"] = args.preview_interval
    if args.preview_file is not None:
        overrides["preview_file"] = args.preview_file
    cfg = cfg.replace(**overrides)

    film = None
    if args.resume:
        if not args.checkpoint:
            print("--resume requires --checkpoint", file=sys.stderr)
            return 2
        film = Film.load(args.checkpoint)
        print(f"resuming from {args.checkpoint} at {film.spp} spp", file=sys.stderr)

    scene, camera = to_device(scene, camera, device, torch.float32)
    renderer = ProgressiveRenderer(scene, camera, cfg, backend=args.backend,
                                   film=film, chunk=args.chunk)
    renderer.run(checkpoint_path=args.checkpoint, quiet=args.quiet)
    if not args.quiet:
        rays, secs = renderer.rays_traced, renderer.render_seconds
        print(f"rendered on {device} ({renderer.backend} backend): {rays:.0f} rays "
              f"in {secs:.3f} s = {rays / secs / 1e6:.3f} Mrays/s", file=sys.stderr)
    for path in renderer.write_outputs():
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
