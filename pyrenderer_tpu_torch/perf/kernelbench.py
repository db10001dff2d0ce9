"""Microbenchmarks of the traversal primitives on the GPU: the probe kernels
and their plain twins, and the harness that times them.

Counterpart of perf/kernelbench.py. On the TPU these probes measured what
the cluster sweep's primitives cost (the numbers that shaped kernels 3-8);
here the same four questions are asked of Hopper, each a hand-written CUDA
kernel in csrc/kernelbench.cu:

  leaf     L unconditional Moeller-Trumbore leaves of 128 rays x 128
           triangles per tile: the speed of light of leaf work
  extract  K dependent block-wide reductions per tile (the TPU's vector ->
           scalar move)
  cond     N uniform branches per tile over one conditional leaf each,
           always taken or never taken
  ctz      a loop over the set bits of a 32-bit word, one conditional leaf
           per bit

and three harnesses time kernels the port already has, on the JAX
harness's wavefronts at terrain(224) (100,352 triangles): sweep (the cluster
closest-hit and any-hit), sort (the coherence sort on a bounce-like
wavefront) and binned (the binned traversal against the sweep).

``leaf``, ``extract``, ``cond`` and ``ctz`` take the device from ``rcol``:
a CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
twin (``leaf_ref`` ...), the same arithmetic in the same order broadcast
over (N, 128). Each counts its launches (``leaf.launches``) and, apart from
them, the calls served by the twin (``leaf.twin_calls``); graph_ms keeps
these counts to the kernels that ran, replays included.

Run on the card: ``python -m pyrenderer_tpu_torch.perf.kernelbench [names]``
(default: all of BENCHES). Times come from CUDA events: for the probes
around the replay of a CUDA graph of REPS launches (graph_ms: a probe
takes about as long as a Python launch), for the other three around
back-to-back calls of the wrappers (cuda_ms: their glue reads the device).
The TPU harness's repeat_jit/INNER only hid its dispatch latency. "us/tile"
is a launch's time over its 256 tiles, as the JAX harness reports it,
though here the tiles run in parallel.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from pyrenderer_tpu_torch.kernels import build

N_TILES = 256          # tiles (CUDA blocks) per launch
RAY_TILE = 128         # rays per tile
MISS = 3e38
REPS = 20              # launches per CUDA-event timing

LEAF_L = (4, 16, 64)
EXTRACT_K = (0, 8, 32, 128)
COND_N = (16, 64)
CTZ_WORDS = ((0x1, "1 bit"), (0xF0F0, "8 bits"), (-1, "32 bits"))


def inputs(n_tiles: int = N_TILES, device="cpu"):
    """The harness's operands, as the JAX harness makes them:
    rcol (n_tiles * 128, 8) and tri (128, 128), float32 standard normals
    from numpy's default_rng(0), in that order."""
    rng = np.random.default_rng(0)
    rcol = rng.standard_normal((n_tiles * RAY_TILE, 8)).astype(np.float32)
    tri = rng.standard_normal((8 * 16, 128)).astype(np.float32)
    return torch.as_tensor(rcol, device=device), torch.as_tensor(tri, device=device)


def set_bits(word: int):
    """Indices of the set bits of the 32-bit `word`, lowest first (Python
    integers: the twin needs no uint32 shifts, which torch lacks)."""
    bits = word & 0xFFFFFFFF
    out = []
    while bits:
        out.append((bits & -bits).bit_length() - 1)
        bits &= bits - 1
    return out


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _block(tri, j):
    b = (j % 8) * 16
    return [tri[b + r:b + r + 1] for r in range(9)]       # nine (1, 128) rows


def leaf_ref(rcol, tri, n_leaves):
    """Twin of the leaf probe: (N, 1) running min of accepted t over
    n_leaves leaves, 3e38 where none; perf/kernelbench.py:70-100's order."""
    rcol, tri = rcol.detach(), tri.detach()
    ox, oy, oz, dx, dy, dz = (rcol[:, c:c + 1] for c in range(6))
    t_best = torch.full((rcol.shape[0], 1), MISS, dtype=rcol.dtype, device=rcol.device)
    for j in range(n_leaves):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = _block(tri, j)
        cx = e1y * dz - e1z * dy
        cy = e1z * dx - e1x * dz
        cz = e1x * dy - e1y * dx
        det = cx * e2x + cy * e2y + cz * e2z
        inv = 1.0 / torch.where(det == 0, 1.0, det)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        qx = sy * e2z - sz * e2y
        qy = sz * e2x - sx * e2z
        qz = sx * e2y - sy * e2x
        t = -inv * (qx * e1x + qy * e1y + qz * e1z)
        u = -inv * (qx * dx + qy * dy + qz * dz)
        v = inv * (cx * sx + cy * sy + cz * sz)
        ok = ((det.abs() > 0) & (t > 1e-4) & (t < t_best) & (u >= 0) & (u <= 1)
              & (v >= 0) & (1 - u - v >= 0))
        tm = torch.where(ok, t, MISS)
        t_best = torch.minimum(t_best, tm.amin(dim=1, keepdim=True))
    return t_best


def extract_ref(rcol, n_ext):
    """Twin of the extract probe: per tile, n_ext rounds of
    acc += max(tile + acc) * 1e-20; (N, 1) with acc on every ray."""
    r = rcol.detach().reshape(-1, RAY_TILE, 8)
    acc = torch.zeros((r.shape[0], 1, 1), dtype=r.dtype, device=r.device)
    for _ in range(n_ext):
        acc = acc + (r + acc).amax(dim=(1, 2), keepdim=True) * 1e-20
    return (torch.zeros((r.shape[0], RAY_TILE, 1), dtype=r.dtype, device=r.device)
            + acc).reshape(-1, 1)


def _cond_leaf(tri, j, o, t_best):
    blk = _block(tri, j)
    v = (blk[0] - o[0]) * (blk[1] - o[1]) * (blk[2] - o[2])
    return torch.minimum(t_best, v.amin(dim=1, keepdim=True))


def _cond_leaves(rcol, tri, js):
    rcol, tri = rcol.detach(), tri.detach()
    o = [rcol[:, c:c + 1] for c in range(3)]
    t_best = torch.full((rcol.shape[0], 1), MISS, dtype=rcol.dtype, device=rcol.device)
    for j in js:
        t_best = _cond_leaf(tri, j, o, t_best)
    return t_best


def cond_ref(rcol, tri, n_conds, taken):
    """Twin of the cond probe: n_conds conditional leaves when `taken`,
    none otherwise (3e38 everywhere)."""
    return _cond_leaves(rcol, tri, range(n_conds) if taken else ())


def ctz_ref(rcol, tri, word):
    """Twin of the ctz probe: one conditional leaf per set bit of the
    32-bit word, lowest bit first."""
    return _cond_leaves(rcol, tri, set_bits(word))


# ---------------------------------------------------------------------------
# kernel wrappers: a CUDA tensor launches, a CPU tensor runs the twin
# ---------------------------------------------------------------------------

def _check(rcol, tri=None):
    """Validate the operands; return the ray count N."""
    dev = rcol.device
    for name, x, shape in (("rcol", rcol, None), ("tri", tri, (128, 128))):
        if x is None:
            continue
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    n = rcol.shape[0]
    if rcol.dim() != 2 or rcol.shape[1] != 8 or n == 0 or n % RAY_TILE:
        raise ValueError(f"rcol must be (N, 8) with N a positive multiple of {RAY_TILE}, "
                         f"got {tuple(rcol.shape)}")
    return n


def _count(name, value):
    if not 0 <= value < 2 ** 31:
        raise ValueError(f"{name} must be in [0, 2^31), got {value}")
    return int(value)


def leaf(rcol, tri, n_leaves):
    """The leaf probe on (N, 8) rays and the (128, 128) table: (N, 1)."""
    if not build.on_cuda(rcol, "leaf"):
        leaf.twin_calls += 1
        return leaf_ref(rcol, tri, n_leaves)
    n = _check(rcol, tri)
    out = torch.empty((n, 1), dtype=torch.float32, device=rcol.device)
    build.launch("pr_kb_leaf", rcol.device, rcol.data_ptr(), tri.data_ptr(), n,
                 _count("n_leaves", n_leaves), out.data_ptr())
    leaf.launches += 1
    return out


def extract(rcol, n_ext):
    """The extract probe on (N, 8) rows: (N, 1)."""
    if not build.on_cuda(rcol, "extract"):
        extract.twin_calls += 1
        return extract_ref(rcol, n_ext)
    n = _check(rcol)
    out = torch.empty((n, 1), dtype=torch.float32, device=rcol.device)
    build.launch("pr_kb_extract", rcol.device, rcol.data_ptr(), n, _count("n_ext", n_ext),
                 out.data_ptr())
    extract.launches += 1
    return out


def cond(rcol, tri, n_conds, taken):
    """The cond probe: (N, 1)."""
    if not build.on_cuda(rcol, "cond"):
        cond.twin_calls += 1
        return cond_ref(rcol, tri, n_conds, taken)
    n = _check(rcol, tri)
    out = torch.empty((n, 1), dtype=torch.float32, device=rcol.device)
    build.launch("pr_kb_cond", rcol.device, rcol.data_ptr(), tri.data_ptr(), n,
                 _count("n_conds", n_conds), int(bool(taken)), out.data_ptr())
    cond.launches += 1
    return out


def ctz(rcol, tri, word):
    """The ctz probe over the set bits of the 32-bit word: (N, 1)."""
    if not build.on_cuda(rcol, "ctz"):
        ctz.twin_calls += 1
        return ctz_ref(rcol, tri, word)
    n = _check(rcol, tri)
    out = torch.empty((n, 1), dtype=torch.float32, device=rcol.device)
    build.launch("pr_kb_ctz", rcol.device, rcol.data_ptr(), tri.data_ptr(), n,
                 word & 0xFFFFFFFF, out.data_ptr())
    ctz.launches += 1
    return out


PROBES = (leaf, extract, cond, ctz)


def reset_counters() -> None:
    """Zero the probes' counts (kernels.reset_counters zeroes every
    wrapper's)."""
    for fn in PROBES:
        fn.launches = 0
        fn.twin_calls = 0


reset_counters()


# ---------------------------------------------------------------------------
# the harness (CUDA only)
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Milliseconds per call of fn(): CUDA events around `reps` calls in a
    row, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = REPS) -> float:
    """Milliseconds per call of fn() with the host's launch cost out of the
    way: `reps` calls captured in one CUDA graph, one replay timed with
    CUDA events (after a warm-up call and an untimed replay). The probes
    take tens of microseconds, about what a Python launch costs, so
    back-to-back launches would time the host.

    The launch counts stay counts of kernels that ran: a wrapper counts a
    launch when the capture records it, which runs nothing, so the
    capture's counts come off and each replay adds them back. One call
    counts 1 + 2 * reps launches of each kernel fn() launches once."""
    from pyrenderer_tpu_torch import kernels

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    wrappers = list(kernels.wrappers().values())
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    captured = [w.launches - b for w, b in zip(wrappers, before)]

    def replay():
        graph.replay()
        for w, c in zip(wrappers, captured):
            w.launches += c

    for w, c in zip(wrappers, captured):
        w.launches -= c
    replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_leaf(dev):
    rcol, tri = inputs(N_TILES, dev)
    out = {}
    for n_leaves in LEAF_L:
        ms = graph_ms(lambda: leaf(rcol, tri, n_leaves))
        per_tile = ms * 1e-3 / N_TILES
        out[n_leaves] = ms
        print(f"leaf    L={n_leaves:3d}: {per_tile * 1e6:8.2f} us/tile  "
              f"{per_tile / n_leaves * 1e9:8.1f} ns/leaf  "
              f"({N_TILES * RAY_TILE * n_leaves * 128 / (ms * 1e-3) / 1e9:.1f} G tri-tests/s)",
              flush=True)
    return out


def bench_extract(dev):
    rcol, _ = inputs(N_TILES, dev)
    out = {}
    for n_ext in EXTRACT_K:
        ms = graph_ms(lambda: extract(rcol, n_ext))
        per_tile = ms * 1e-3 / N_TILES
        out[n_ext] = ms
        print(f"extract K={n_ext:3d}: {per_tile * 1e6:8.2f} us/tile  "
              f"{per_tile / max(n_ext, 1) * 1e9:8.1f} ns/extract", flush=True)
    return out


def bench_cond(dev):
    rcol, tri = inputs(N_TILES, dev)
    out = {}
    for taken in (False, True):
        for n_conds in COND_N:
            ms = graph_ms(lambda: cond(rcol, tri, n_conds, taken))
            out[(n_conds, taken)] = ms
            print(f"cond    N={n_conds:3d} taken={taken}: "
                  f"{ms * 1e3 / N_TILES:8.2f} us/tile  "
                  f"{ms * 1e6 / N_TILES / n_conds:8.1f} ns/cond", flush=True)
    return out


def bench_ctz(dev):
    rcol, tri = inputs(N_TILES, dev)
    out = {}
    for word, label in CTZ_WORDS:
        ms = graph_ms(lambda: ctz(rcol, tri, word))
        out[word] = ms
        print(f"ctz     {label:8s}: {ms * 1e3 / N_TILES:8.2f} us/tile  "
              f"{ms * 1e6 / N_TILES / len(set_bits(word)):8.1f} ns/iter", flush=True)
    return out


def _terrain_clusters(dev, res):
    from pyrenderer_tpu_torch.accel.clusters import build_clusters
    from pyrenderer_tpu_torch.scene.procgen import terrain

    verts, faces = terrain(res)
    t0 = time.perf_counter()
    cs = build_clusters(verts, faces).to(dev)
    return faces.shape[0], cs, time.perf_counter() - t0


def camera_rays(dev, n=N_TILES * RAY_TILE):
    """The JAX harness's coherent wavefront: one origin above the terrain,
    directions through a row-major 256-wide pixel grid on y = 0."""
    w, h = 256, n // 256
    ys, xs = np.mgrid[0:h, 0:w]
    u = (xs.ravel() + 0.5) / w - 0.5
    v = (ys.ravel() + 0.5) / h - 0.5
    ro = np.broadcast_to(np.asarray([0.0, 1.2, 1.4], np.float32), (n, 3))
    rd = np.stack([u, np.zeros(n), v], axis=1) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.as_tensor(np.ascontiguousarray(ro), device=dev),
            torch.as_tensor(rd.astype(np.float32), device=dev))


def bounce_rays(dev, n=N_TILES * RAY_TILE):
    """The JAX harness's incoherent wavefront (default_rng(2)): origins
    scattered over the terrain, uniformly random directions."""
    rng = np.random.default_rng(2)
    ro = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(0.05, 0.4, n),
                   rng.uniform(-0.9, 0.9, n)], axis=1).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.as_tensor(ro, device=dev), torch.as_tensor(rd, device=dev)


def bench_sweep(dev, res=224):
    from pyrenderer_tpu_torch.kernels import cluster as kc

    n_tris, cs, secs = _terrain_clusters(dev, res)
    print(f"sweep   build: {n_tris} tris, {cs.n_clusters} clusters, "
          f"{cs.n_superclusters} supers ({secs:.1f}s)", flush=True)
    n = N_TILES * RAY_TILE
    ro, rd = camera_rays(dev, n)
    t0 = time.perf_counter()
    hit, _, _ = kc.closest_hit(cs, ro, rd, 1e-4, 1e9)
    rate = float(hit.float().mean())
    print(f"sweep   closest first call: {time.perf_counter() - t0:.1f}s, "
          f"hit rate {rate:.3f}", flush=True)
    out = {}
    for name, fn in (("closest", lambda: kc.closest_hit(cs, ro, rd, 1e-4, 1e9)),
                     ("anyhit ", lambda: kc.occluded(cs, ro, rd, 1e-4, 1e9))):
        ms = cuda_ms(fn, reps=4)
        out[name.strip()] = ms
        print(f"sweep   {name}: {ms * 1e3 / N_TILES:8.2f} us/tile  "
              f"{n / (ms * 1e-3) / 1e6:8.1f} Mrays/s", flush=True)
    return out


def bench_sort(dev, res=224):
    """An incoherent (bounce-like) wavefront through the cluster closest
    hit, sorted and unsorted: does the coherence sort pay for itself?"""
    from pyrenderer_tpu_torch.kernels import cluster as kc

    _, cs, _ = _terrain_clusters(dev, res)
    n = N_TILES * RAY_TILE
    ro, rd = bounce_rays(dev, n)
    out = {}
    for sort in (False, True):
        ms = cuda_ms(lambda: kc.closest_hit(cs, ro, rd, 1e-4, 1e9, sort=sort), reps=3)
        out[sort] = ms
        print(f"sort={sort!s:5s}: {ms * 1e3 / N_TILES:8.2f} us/tile  "
              f"{n / (ms * 1e-3) / 1e6:8.1f} Mrays/s", flush=True)
    return out


def bench_binned(dev, res=224):
    """The binned traversal against the sweep on bench_sweep's and
    bench_sort's wavefronts, closest hit and any hit (t1 = 2)."""
    from pyrenderer_tpu_torch.kernels import binned as kb
    from pyrenderer_tpu_torch.kernels import cluster as kc

    n_tris, cs, _ = _terrain_clusters(dev, res)
    print(f"binned  scene: {n_tris} tris, {cs.n_clusters} clusters", flush=True)
    n = N_TILES * RAY_TILE
    out = {}
    for label, (ro, rd) in (("camera", camera_rays(dev, n)), ("bounce", bounce_rays(dev, n))):
        sort = label == "bounce"
        cases = (
            ("binned", lambda: kb.closest_hit(cs, ro, rd, 1e-4, 1e9), True),
            ("sweep ", lambda: kc.closest_hit(cs, ro, rd, 1e-4, 1e9, sort=sort), True),
            ("binned-any", lambda: kb.occluded(cs, ro, rd, 1e-4, 2.0), False),
            ("sweep -any", lambda: kc.occluded(cs, ro, rd, 1e-4, 2.0, sort=sort), False),
        )
        for name, fn, first in cases:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ct = time.perf_counter() - t0
            ms = cuda_ms(fn, reps=3)
            out[(label, name.strip())] = ms
            tail = f"   (first call {ct:.1f}s)" if first else ""
            print(f"binned  {label} {name}: {ms * 1e3 / N_TILES:8.2f} us/tile  "
                  f"{n / (ms * 1e-3) / 1e6:8.1f} Mrays/s{tail}", flush=True)
    return out


BENCHES = {
    "leaf": bench_leaf,
    "extract": bench_extract,
    "cond": bench_cond,
    "ctz": bench_ctz,
    "sweep": bench_sweep,
    "sort": bench_sort,
    "binned": bench_binned,
}


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(BENCHES)
    unknown = [name for name in names if name not in BENCHES]
    if unknown:
        print(f"unknown benchmarks {unknown}; choose from {list(BENCHES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the microbenchmarks run on a GPU only", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for name in names:
        BENCHES[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
