"""CLI: ``python -m pyrenderer_tpu_torch.render.cli scene.json [flags]``,
or ``... tonemap --input hdr.exr|hdr.npy [--tonemap OP] [--out x.png]``.

Counterpart of pyrenderer_tpu/render/cli.py, with the same flags and
defaults. It computes on ``cuda:0`` unless ``--cpu`` is given; with no GPU
and no ``--cpu`` it exits 2, it never falls back to the CPU.

Scene-file mode renders progressively (render/driver.py): adaptive
sampling when the scene sets ``renderer.adaptive_sampling``, retries with
``--resilient [RETRIES]``, an ANSI view of the accumulating film on stderr
with ``--live [PASSES]`` (which silences the progress prints). Like the JAX
CLI it defaults to ``--estimator pbrt`` (core/integrator_pbrt.py);
``--estimator reference`` reproduces the reference renderer's tracer.
The ``tonemap`` mode maps a saved HDR (EXR, ZIP or PIZ, or NPY) to a PNG.
The ``analytic`` mode renders the self-contained analytic-primitive scene
(analytic.py, the reference's taichi_ref.py) at 400x400, 25 spp and depth
10 unless told otherwise. ``--debug-paths OUT.html`` traces a grid of
``--debug-rays`` pixels once, recording every bounce (debug/logger.py), and
writes the HTML viewer and OUT.ply instead of rendering. ``--trace-dir
DIR`` profiles the render's first TRACE_PASSES passes: a Chrome trace with
the program's spans among the kernels, and a summary of the spans a pass.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

# the passes --trace-dir profiles, from the first: the trace and the spans
# stay in memory until they are written, and a long-lived profiler drops
# events, so the rest of the render runs unprofiled
TRACE_PASSES = 3

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pyrenderer_tpu_torch",
        description="Path tracer on PyTorch and CUDA",
    )
    p.add_argument(
        "scene",
        help="Tungsten scene JSON; the literal 'analytic' for the self-contained "
        "analytic-primitive scene (the reference's taichi_ref.py); or the literal "
        "'tonemap' to map a saved HDR (--input .exr or .npy) to a PNG",
    )
    p.add_argument("--input", help="tonemap mode: HDR input (.exr or .npy)")
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
        choices=["auto", "cuda", "brute", "matmul", "pallas", "bvh", "cluster",
                 "cluster_binned", "cluster_streamed", "cluster_chunked",
                 "watertight"],
        default="auto",
        help="intersection backend: auto = the whole-table CUDA kernels on a "
        "GPU (the plain PyTorch test on the CPU) up to 4096 triangles, above "
        "the cluster sweep on a GPU (the binned traversal under "
        "PYRENDERER_CLUSTER_IMPL=binned) and the BVH on the CPU; matmul = the "
        "test as one IEEE float32 matrix product (explicit only); pallas raises "
        "(its port is cuda)",
    )
    p.add_argument("--chunk", type=int, default=1 << 16,
                   help="rays per dispatch chunk (default 2^16)")
    p.add_argument("--preview-interval", type=int,
                   help="dump a tonemapped preview PNG every N passes")
    p.add_argument("--preview-file", help="preview PNG path (default preview.png)")
    p.add_argument("--checkpoint", help="checkpoint .npz path (enables save)")
    p.add_argument("--checkpoint-interval", type=int, help="passes between checkpoints")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    p.add_argument(
        "--resilient", type=int, nargs="?", const=3, default=0, metavar="RETRIES",
        help="retry failed passes and reject non-finite ones (default 3 "
        "retries when given without a value)",
    )
    p.add_argument(
        "--live", type=int, nargs="?", const=1, default=0, metavar="PASSES",
        help="redraw the accumulating render on stderr every N passes (ANSI "
        "half-blocks); silences the progress prints",
    )
    p.add_argument("--cpu", action="store_true",
                   help="compute on the CPU with the plain PyTorch versions")
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--debug-paths", metavar="OUT.html",
        help="instead of rendering, trace a coarse pixel grid recording every "
        "bounce and write a self-contained interactive HTML viewer (scene "
        "wireframe + ray/shadow polylines), the reference's `main.py -d` open3d "
        "mode, headless (debug/logger.py; also writes OUT.ply next to it)",
    )
    p.add_argument("--debug-rays", type=int, default=49,
                   help="ray count for --debug-paths (a sqrt-grid of pixels)")
    p.add_argument(
        "--trace-dir", metavar="DIR",
        help=f"profile the first {TRACE_PASSES} passes of the render (the first one builds "
        "the kernels) and write into DIR one Chrome trace that holds the program's spans "
        "(pass, chunk, bounce, rng, query, launch, ...) beside the device's kernels, on "
        "one clock, and spans_*.json: each span's count, ms and self ms a pass, and on "
        "CUDA the host's waits for the device a pass, over the profiled passes and over "
        "those after the first (utils/profiling.py)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda:0")
    else:
        print("no CUDA device: pass --cpu to compute on the CPU", file=sys.stderr)
        return 2
    if args.scene == "analytic":
        return _main_analytic(args, device)
    if args.scene == "tonemap":
        return _main_tonemap(args, device)

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

    if args.debug_paths:
        return _main_debug_paths(args, scene, camera, cfg, device)

    film = None
    if args.resume:
        if not args.checkpoint:
            print("--resume requires --checkpoint", file=sys.stderr)
            return 2
        film = Film.load(args.checkpoint)
        print(f"resuming from {args.checkpoint} at {film.spp} spp", file=sys.stderr)

    on_pass = None
    if args.live:
        from pyrenderer_tpu_torch.utils.termview import LiveView

        view = LiveView()
        passes = 0

        def on_pass(r):
            # counts passes, uniform and adaptive alike: spp advances by
            # spp_step a pass and stalls during the adaptive sweeps
            nonlocal passes
            passes += 1
            if passes % args.live == 0:
                view.update(r.ldr(), f"{r.film.spp}/{r.cfg.spp} spp")

    traced = contextlib.ExitStack()
    if args.trace_dir:
        view_pass, traced_passes = on_pass, 0

        def on_pass(r):
            # ends the profile after TRACE_PASSES passes, between two passes
            nonlocal traced_passes
            traced_passes += 1
            if traced_passes == TRACE_PASSES:
                traced.close()
            if view_pass:
                view_pass(r)

    scene, camera = to_device(scene, camera, device, torch.float32)
    renderer = ProgressiveRenderer(scene, camera, cfg, backend=args.backend,
                                   film=film, chunk=args.chunk, on_pass=on_pass)
    # the live view redraws in place by rewinding exactly its own lines:
    # any other print between frames would corrupt it
    quiet = args.quiet or bool(args.live)
    rec = None
    with traced:
        if args.trace_dir:
            from pyrenderer_tpu_torch.utils import profiling

            traced.enter_context(profiling.trace_profile(args.trace_dir))
            rec = traced.enter_context(profiling.recording(device))
        if args.resilient:
            renderer.run_resilient(checkpoint_path=args.checkpoint,
                                   max_retries=args.resilient, quiet=quiet)
        else:
            renderer.run(checkpoint_path=args.checkpoint, quiet=quiet)
    if not quiet:
        rays, secs = renderer.rays_traced, renderer.render_seconds
        print(f"rendered on {device} ({renderer.backend} backend): {rays:.0f} rays "
              f"in {secs:.3f} s = {rays / secs / 1e6:.3f} Mrays/s", file=sys.stderr)
    written = renderer.write_outputs()
    if rec is not None:
        path = os.path.join(args.trace_dir, f"spans_{os.getpid()}_{time.time_ns()}.json")
        with open(path, "w") as f:
            # the first pass also builds the kernels
            json.dump({"device": str(device), "passes": rec.summary("pass"),
                       "passes_after_first": rec.summary("pass", skip=1)}, f, indent=1)
        written.append(path)
    for path in written:
        print(f"wrote {path}", file=sys.stderr)
    return 0


def _main_tonemap(args, device) -> int:
    """Offline tonemapper: a saved HDR (.exr or .npy) -> LDR PNG, the
    operator (default sqrt) applied on `device`, the role of the
    reference's tone_map.py."""
    import numpy as np
    import torch

    from pyrenderer_tpu_torch.core.tonemap import tonemap
    from pyrenderer_tpu_torch.utils.image_io import write_png

    if not args.input:
        print("tonemap mode requires --input (.exr or .npy)", file=sys.stderr)
        return 2
    if args.input.endswith(".exr"):
        from pyrenderer_tpu_torch.utils.exr import read_exr

        hdr = read_exr(args.input)[:, :, :3]
    else:
        hdr = np.load(args.input)
    op = args.tonemap or "sqrt"
    ldr = tonemap(torch.as_tensor(hdr, dtype=torch.float32, device=device), op)
    out = args.out or "tonemapped.png"
    write_png(out, ldr.cpu().numpy())
    print(f"wrote {out} ({op} on {device}, {hdr.shape[1]}x{hdr.shape[0]})", file=sys.stderr)
    return 0


def _main_debug_paths(args, scene, camera, cfg, device) -> int:
    """Trace a sqrt-grid of --debug-rays pixels at the render's resolution
    once, recording every bounce, and write the HTML viewer and the PLY
    beside it."""
    import numpy as np

    from pyrenderer_tpu_torch.debug.logger import log_paths
    from pyrenderer_tpu_torch.scene import to_device

    w, h = cfg.resolution or camera.resolution
    scene, camera = to_device(scene, camera._replace(resolution=(w, h)), device)
    side = max(1, int(args.debug_rays ** 0.5))
    xs = (np.arange(side) + 0.5) * (w / side)
    ys = (np.arange(side) + 0.5) * (h / side)
    px, py = np.meshgrid(xs.astype(np.int32), ys.astype(np.int32))
    log = log_paths(scene, camera, cfg, px.reshape(-1), py.reshape(-1),
                    backend=args.backend)
    log.write_html(args.debug_paths, scene=scene)
    ply = args.debug_paths.rsplit(".", 1)[0] + ".ply"
    log.write_ply(ply)
    print(f"wrote {args.debug_paths} and {ply} ({side * side} paths)", file=sys.stderr)
    return 0


def _main_analytic(args, device) -> int:
    """Render the hardcoded analytic-primitive scene on `device`.

    The reference counterpart is `python taichi_ref.py`, a standalone
    renderer outside the Tungsten pipeline (taichi_ref.py:441-511); flags
    that only make sense for scene-driven renders are ignored."""
    import numpy as np

    from pyrenderer_tpu_torch import analytic
    from pyrenderer_tpu_torch.utils.image_io import write_png

    res = tuple(args.res) if args.res is not None else (400, 400)
    spp = args.spp if args.spp is not None else 25
    depth = args.depth if args.depth is not None else analytic.MAX_DEPTH
    hdr = analytic.render(res=res, spp=spp, seed=args.seed, max_depth=depth, device=device)
    out = args.out or "analytic.png"
    write_png(out, analytic.tonemap(hdr).cpu().numpy())
    if args.hdr_out:
        np.save(args.hdr_out, hdr.cpu().numpy())
        print(f"wrote {args.hdr_out}", file=sys.stderr)
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
