"""The binned traversal's pair granularity: the same wavefront through bins
of 4, 1 and 2 clusters (PYRENDERER_BIN), one process each.

Counterpart of perf/binnedgran.py. A bin is BIN adjacent 128-triangle
clusters (accel/clusters.py); finer bins give the prepass more, smaller
boxes and the leaf fewer triangles per (bin, ray) pair. BIN is read when
accel/clusters.py is imported (the scene's bin boxes and the leaf kernels
must agree on it), so each value runs in a child process of its own, with
a timeout. Each child builds terrain res 224 (100,352 triangles), traces
N = 262,144 rays from numpy.random.default_rng(0) (perf/binnedglue.py's)
and prints one JSON line (with its process's kernel launches, which the
parent sums): the bins, the candidates per ray and the
overflow share of the prepass at W = 6, the resident core's eager ms
(perf/binnedglue.core, which reads the device, so not captured; not
profiled) and its
Mrays/s, and the hit agreement of the public binned closest_hit with the
sweep's twin accel/clusters.closest_hit_ref on the first 4,096 rays.

Where the JAX harness prints "FAILED" for a child and goes on, this one
prints the child's error and exits 1 after the last child: a run that
lacks a row is not a result.

    python -m pyrenderer_tpu_torch.perf.binnedgran [--bins 4 1 2] [--n N] [--res R]
        [--reps R] [--timeout S] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

from pyrenderer_tpu_torch.perf import binnedglue, harness

N = 262144
RES = 224
BINS = (4, 1, 2)
AGREE_RAYS = 4096
CHILD_TIMEOUT = 600.0
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def child(device, args) -> dict:
    """One BIN's measurements in this process (BIN is this process's), with
    the process's kernel launches and twin calls."""
    from pyrenderer_tpu_torch import kernels
    from pyrenderer_tpu_torch.accel import clusters as cl
    from pyrenderer_tpu_torch.kernels import binned
    from pyrenderer_tpu_torch.utils.profiling import slope_time

    x = binnedglue.inputs(device, args.n, args.res)
    cand = float((x.ids != binned.SENTINEL).sum()) / args.n
    st = slope_time(binnedglue.core, x.cs, x.ro, x.rd, x.t1v, False, reps=args.reps,
                    profile=False)
    m = min(AGREE_RAYS, args.n)
    hit, _, _ = binned.closest_hit(x.cs, x.ro[:m], x.rd[:m], binnedglue.T0, binnedglue.T1,
                                   exact_t=False)
    hit_ref, _, _ = cl.closest_hit_ref(x.cs, x.ro[:m], x.rd[:m], binnedglue.T0, binnedglue.T1)
    launches, twins = kernels.counts()
    return {"bin": cl.BIN, "launches_total": launches, "twin_calls_total": twins, "bins": x.n_bins, "w": x.w, "candidates_per_ray": cand,
            "overflow_pct": float(x.ovf.float().mean()) * 100, "core_ms": st.eager_ms,
            "mrays_per_s": args.n / (st.eager_ms * 1e-3) / 1e6 if st.eager_ms > 0 else None,
            "launches": st.launches, "twin_calls": st.twin_calls,
            "hit_agree": float((hit == hit_ref).float().mean()), "agree_rays": m,
            "hits": int(hit_ref.sum())}


def run(device, args):
    card = harness.card(device)
    print(f"binnedgran: device {device} ({card}), N={args.n}, res={args.res}, "
          f"BIN in {args.bins}", flush=True)
    rows, failed = [], []
    for b in args.bins:
        env = dict(os.environ, PYRENDERER_BIN=str(b),
                   PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                                              if p))
        cmd = [sys.executable, "-m", "pyrenderer_tpu_torch.perf.binnedgran", "--child",
               "--device", str(device), "--n", str(args.n), "--res", str(args.res),
               "--reps", str(args.reps)]
        try:
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=args.timeout)
            out, err, rc = r.stdout, r.stderr, r.returncode
        except subprocess.TimeoutExpired as e:
            out, err, rc = e.stdout or "", f"timed out after {args.timeout} s", None
        lines = [ln for ln in (out or "").splitlines() if ln.startswith("{")]
        if rc != 0 or not lines:
            failed.append(b)
            err = err if isinstance(err, str) else err.decode(errors="replace")
            print(f"BIN={b} FAILED (exit {rc}):\n{err[-4000:]}", file=sys.stderr, flush=True)
            continue
        row = json.loads(lines[-1])
        rows.append(row)
        rate = "-" if row["mrays_per_s"] is None else f"{row['mrays_per_s']:.3f}"
        print(f"BIN={row['bin']}: bins={row['bins']} cand/ray={row['candidates_per_ray']:.3f} "
              f"ovf={row['overflow_pct']:.3f}% core={row['core_ms']:.4f} ms ({rate} Mrays/s) "
              f"launches/call {row['launches']}; hit agree {row['hit_agree']:.4f} "
              f"on {row['agree_rays']} rays", flush=True)
    totals = [sum((collections.Counter(r[k]) for r in rows), collections.Counter())
              for k in ("launches_total", "twin_calls_total")]
    return {"harness": "binnedgran", "device": str(device), "card": card, "n": args.n,
            "res": args.res, "reps": args.reps, "rows": rows, "failed": failed,
            "launches_total": dict(totals[0]), "twin_calls_total": dict(totals[1])}


def main(argv=None) -> int:
    p = harness.parser(__doc__.split("\n\n")[0], N, profile=False)
    p.add_argument("--res", type=int, default=RES, help=f"terrain res (default {RES})")
    p.add_argument("--bins", type=int, nargs="+", default=list(BINS),
                   help="values of PYRENDERER_BIN, one child each (default 4 1 2)")
    p.add_argument("--timeout", type=float, default=CHILD_TIMEOUT,
                   help=f"seconds a child may take (default {CHILD_TIMEOUT:.0f})")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    device = harness.device_of(args.device)
    if device is None:
        print(harness.NO_GPU, file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(device, args)), flush=True)
        return 0
    result = run(device, args)
    print(json.dumps(result), flush=True)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
