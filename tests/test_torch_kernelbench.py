"""pyrenderer_tpu_torch.perf.kernelbench: the probe twins against the TPU
kernels of perf/kernelbench.py (run in interpret mode), the wrappers on the
CPU, and the kernels against the twins on a card."""

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pyrenderer_tpu_torch.perf import clusterbench as cb
from pyrenderer_tpu_torch.perf import kernelbench as kb

torch.set_num_threads(2)

# the JAX harness, imported as bench.py's calibrate() imports it
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "perf"))
import kernelbench as kb_jax  # noqa: E402

N_TILES = 4


@pytest.fixture(scope="module")
def operands():
    return kb.inputs(N_TILES, "cpu")


def _pallas(kernel, rcol, *tables):
    """pl.pallas_call of one of perf/kernelbench.py's kernel bodies over
    N_TILES tiles, in interpret mode (the blocking of the JAX harness,
    without its TPU memory spaces)."""
    n = rcol.shape[0]
    in_specs = [pl.BlockSpec((kb.RAY_TILE, 8), lambda i: (i, 0))]
    in_specs += [pl.BlockSpec((128, 128), lambda i: (0, 0)) for _ in tables]
    out = pl.pallas_call(
        kernel, grid=(n // kb.RAY_TILE,), in_specs=in_specs,
        out_specs=pl.BlockSpec((kb.RAY_TILE, 1), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, 1), jnp.float32), interpret=True,
    )(jnp.asarray(rcol.numpy()), *(jnp.asarray(t.numpy()) for t in tables))
    return np.asarray(out)


def test_inputs_are_the_jax_harness_operands():
    rcol, tri = kb.inputs(N_TILES, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        rcol.numpy(), np.asarray(jnp.asarray(rng.standard_normal((N_TILES * 128, 8)),
                                             jnp.float32)))
    np.testing.assert_array_equal(
        tri.numpy(), np.asarray(jnp.asarray(rng.standard_normal((128, 128)), jnp.float32)))
    assert kb.N_TILES == kb_jax.N_TILES and kb.RAY_TILE == kb_jax.RAY_TILE


def _leaf_np(rcol, tri, n_leaves):
    """float32 NumPy evaluation of _leaf_kernel in its operation order (NumPy
    never fuses a multiply into an add)."""
    r = rcol.numpy()
    ox, oy, oz, dx, dy, dz = (r[:, c:c + 1] for c in range(6))
    t_best = np.full((r.shape[0], 1), kb.MISS, np.float32)
    for j in range(n_leaves):
        b = tri.numpy()[(j % 8) * 16:(j % 8) * 16 + 9]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (b[k:k + 1] for k in range(9))
        cx, cy, cz = e1y * dz - e1z * dy, e1z * dx - e1x * dz, e1x * dy - e1y * dx
        det = cx * e2x + cy * e2y + cz * e2z
        inv = np.float32(1.0) / np.where(det == 0, np.float32(1.0), det)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        qx, qy, qz = sy * e2z - sz * e2y, sz * e2x - sx * e2z, sx * e2y - sy * e2x
        t = -inv * (qx * e1x + qy * e1y + qz * e1z)
        u = -inv * (qx * dx + qy * dy + qz * dz)
        v = inv * (cx * sx + cy * sy + cz * sz)
        ok = ((np.abs(det) > 0) & (t > np.float32(1e-4)) & (t < t_best) & (u >= 0) & (u <= 1)
              & (v >= 0) & (np.float32(1) - u - v >= 0))
        t_best = np.minimum(t_best, np.where(ok, t, np.float32(kb.MISS)).min(axis=1,
                                                                             keepdims=True))
    return t_best


def _extract_np(rcol, n_ext):
    r = rcol.numpy().reshape(-1, kb.RAY_TILE * 8)
    acc = np.zeros((r.shape[0], 1), np.float32)
    for _ in range(n_ext):
        acc = acc + (r + acc).max(axis=1, keepdims=True) * np.float32(1e-20)
    return np.repeat(acc, kb.RAY_TILE, axis=0)


# XLA:CPU contracts a*b + c into FMAs, so interpret mode rounds the leaf's
# t (and extract's acc + s * 1e-20) differently from the unfused twin, the
# -fmad=false kernel and the TPU (ROADMAP C); where q.e1 cancels, that moves
# t by up to 1.5e-4 relative on these inputs. The twins equal the float32
# NumPy evaluation of the same kernel body bit for bit, and interpret mode
# to rtol 1e-3 with the same misses.


@pytest.mark.parametrize("n_leaves", kb.LEAF_L)
def test_leaf_twin_equals_pallas(operands, n_leaves):
    rcol, tri = operands
    ref = _pallas(partial(kb_jax._leaf_kernel, n_leaves), rcol, tri)
    out = kb.leaf_ref(rcol, tri, n_leaves).numpy()
    assert (out < kb.MISS).mean() > 0.5      # most rays hit something
    np.testing.assert_array_equal(out, _leaf_np(rcol, tri, n_leaves))
    np.testing.assert_array_equal(out < kb.MISS, ref < kb.MISS)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=0)


@pytest.mark.parametrize("n_ext", kb.EXTRACT_K)
def test_extract_twin_equals_pallas(operands, n_ext):
    rcol, _ = operands
    ref = _pallas(partial(kb_jax._extract_kernel, n_ext), rcol)
    out = kb.extract_ref(rcol, n_ext).numpy()
    assert (out > 0).all() == (n_ext > 0)
    np.testing.assert_array_equal(out, _extract_np(rcol, n_ext))
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=0)


@pytest.mark.parametrize("taken", [False, True])
@pytest.mark.parametrize("n_conds", kb.COND_N)
def test_cond_twin_equals_pallas(operands, n_conds, taken):
    rcol, tri = operands
    ref = _pallas(partial(kb_jax._cond_kernel, n_conds, taken), rcol, tri)
    out = kb.cond_ref(rcol, tri, n_conds, taken).numpy()
    assert (out < kb.MISS).all() == taken
    np.testing.assert_array_equal(out, ref)


EDGE_LABELS = ("harness",) + cb.PROBE_EDGES


@pytest.fixture(scope="module")
def edge_sets():
    """The harness's operands at 2 tiles and the four edge sets of
    cb.probe_edges (256 rays each)."""
    return dict(harness=kb.inputs(2, "cpu"), **cb.probe_edges(2, "cpu"))


@pytest.mark.parametrize("n_leaves", cb.PROBE_COUNTS)
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_leaf_twin_equals_pallas_on_edges(edge_sets, label, n_leaves):
    """Ties in t, det == 0, zero directions, origins on a vertex, and L of
    0, 1, 7 and 9: the same misses as interpret mode and t to rtol 1e-3
    (XLA:CPU's FMAs), the float32 NumPy evaluation bit for bit."""
    rcol, tri = edge_sets[label]
    ref = _pallas(partial(kb_jax._leaf_kernel, n_leaves), rcol, tri)
    out = kb.leaf_ref(rcol, tri, n_leaves).numpy()
    np.testing.assert_array_equal(out, _leaf_np(rcol, tri, n_leaves))
    np.testing.assert_array_equal(out < kb.MISS, ref < kb.MISS)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=0)
    if n_leaves == 0:
        assert (out == np.float32(kb.MISS)).all()
    if label == "zero direction":
        assert (out[::2] == np.float32(kb.MISS)).all()


@pytest.mark.parametrize("taken", [False, True])
@pytest.mark.parametrize("n_conds", cb.PROBE_COUNTS)
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_cond_twin_equals_pallas_on_edges(edge_sets, label, n_conds, taken):
    """The cond twin equals interpret mode on the edge sets at 0, 1, 7 and
    9 branches, taken or not; the on-vertex set's even rays reach the exact
    0 of their vertex."""
    rcol, tri = edge_sets[label]
    ref = _pallas(partial(kb_jax._cond_kernel, n_conds, taken), rcol, tri)
    out = kb.cond_ref(rcol, tri, n_conds, taken).numpy()
    np.testing.assert_array_equal(out, ref)
    if label == "origin on a vertex" and taken and n_conds:
        assert (out[::2] == 0).all()


# A model of the kernels' lane split: G lanes share a ray and each keeps a
# running minimum of its own tests (the leaf accepting t only below it),
# and the lanes' minima meet at the end. csrc/kernelbench.cu relies on it
# giving the serial loop's result bit for bit. The leaf's lane g takes
# triangles g, g + G, ... of every leaf in that order (the kernel: G = 8);
# the cond's lane l takes triangles l * 128 / G ... (l + 1) * 128 / G - 1
# (the kernel: 32 lanes of 4 triangles, for each of a warp's rays).

def _leaf_lanes(rcol, tri, n_leaves, g):
    ox, oy, oz, dx, dy, dz = (rcol[:, c:c + 1] for c in range(6))
    best = torch.full((rcol.shape[0], g), kb.MISS, dtype=rcol.dtype)
    for j in range(n_leaves):
        blk = kb._block(tri, j)
        for k in range(0, 128, g):
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (row[:, k:k + g] for row in blk)
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
            ok = ((det.abs() > 0) & (t > 1e-4) & (t < best) & (u >= 0) & (u <= 1)
                  & (v >= 0) & (1 - u - v >= 0))
            best = torch.where(ok, t, best)
    return best.amin(dim=1, keepdim=True)


def _cond_lanes(rcol, tri, n_conds, taken, g):
    o = [rcol[:, c:c + 1] for c in range(3)]
    best = torch.full((rcol.shape[0], g), kb.MISS, dtype=rcol.dtype)
    for j in range(n_conds if taken else 0):
        blk = kb._block(tri, j)
        p = ((blk[0] - o[0]) * (blk[1] - o[1]) * (blk[2] - o[2])).view(-1, g, 128 // g)
        for k in range(128 // g):
            best = torch.minimum(best, p[:, :, k])
    return best.amin(dim=1, keepdim=True)


LANES = (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("g", LANES)
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_leaf_lane_split_equals_twin(edge_sets, label, g):
    """The lane split of the leaf, lane minima with t accepted below the
    lane's own, equals leaf_ref bit for bit (9 leaves: every row block, one
    twice)."""
    rcol, tri = edge_sets[label]
    ref = kb.leaf_ref(rcol, tri, 9)
    out = _leaf_lanes(rcol, tri, 9, g)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert (ref < kb.MISS).any()


@pytest.mark.parametrize("g", LANES)
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_cond_lane_split_equals_twin(edge_sets, label, g):
    """The cond's lane minima equal cond_ref bit for bit (7 and 9
    branches, taken; none when not taken)."""
    rcol, tri = edge_sets[label]
    for n_conds, taken in ((7, True), (9, True), (9, False)):
        ref = kb.cond_ref(rcol, tri, n_conds, taken)
        out = _cond_lanes(rcol, tri, n_conds, taken, g)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_edge_operands_are_edges(edge_sets):
    """Each edge set holds its edge: exact repeats, e1 = 0, zero
    directions, origins on a vertex."""
    base_r, base_t = edge_sets["harness"]
    _, tri = edge_sets["ties"]
    for src, dst in cb.PROBE_TIES:
        assert torch.equal(tri[:, src], tri[:, dst])
    _, tri = edge_sets["degenerate"]
    for b in range(8):
        assert (tri[b * 16 + 3:b * 16 + 6, list(cb.PROBE_DEGENERATE)] == 0).all()
    rcol, _ = edge_sets["zero direction"]
    assert (rcol[::2, 3:6] == 0).all() and torch.equal(rcol[1::2], base_r[1::2])
    rcol, tri = edge_sets["origin on a vertex"]
    assert torch.equal(rcol[1, 0:3], tri[16:19, 37])
    assert all(r.shape == (256, 8) and t.shape == (128, 128)
               for r, t in edge_sets.values())


@pytest.mark.parametrize("word", [w for w, _ in kb.CTZ_WORDS])
def test_ctz_twin_equals_pallas(operands, word):
    rcol, tri = operands
    ref = _pallas(partial(kb_jax._ctz_kernel, word), rcol, tri)
    out = kb.ctz_ref(rcol, tri, word).numpy()
    np.testing.assert_array_equal(out, ref)


def test_set_bits():
    assert kb.set_bits(0x1) == [0]
    assert kb.set_bits(0xF0F0) == [4, 5, 6, 7, 12, 13, 14, 15]
    assert kb.set_bits(-1) == list(range(32))
    assert kb.set_bits(0) == []


def test_wrappers_on_cpu_run_the_twins(operands):
    rcol, tri = operands
    kb.reset_counters()
    assert torch.equal(kb.leaf(rcol, tri, 4), kb.leaf_ref(rcol, tri, 4))
    assert torch.equal(kb.extract(rcol, 8), kb.extract_ref(rcol, 8))
    assert torch.equal(kb.cond(rcol, tri, 16, True), kb.cond_ref(rcol, tri, 16, True))
    assert torch.equal(kb.ctz(rcol, tri, 0xF0F0), kb.ctz_ref(rcol, tri, 0xF0F0))
    assert [fn.twin_calls for fn in kb.PROBES] == [1, 1, 1, 1]
    assert [fn.launches for fn in kb.PROBES] == [0, 0, 0, 0]
    kb.reset_counters()


def test_kernel_counts_cover_every_wrapper(operands):
    """kernels.wrappers() names the fourteen wrappers (the resume mode's two
    passes among them); reset_counters zeroes all of them and counts()
    reports the nonzero ones."""
    from pyrenderer_tpu_torch import kernels

    fns = kernels.wrappers()
    assert len(fns) == 14 and {"kb_leaf", "kb_ctz", "closest_hit", "cluster_closest_suspend",
                               "cluster_closest_resume"} <= set(fns)
    assert all(hasattr(fn, "launches") and hasattr(fn, "twin_calls") for fn in fns.values())
    rcol, tri = operands
    kernels.reset_counters()
    kb.leaf(rcol, tri, 4)
    kb.leaf(rcol, tri, 4)
    kb.ctz(rcol, tri, 1)
    assert kernels.counts() == ({}, {"kb_leaf": 2, "kb_ctz": 1})
    kernels.reset_counters()
    assert kernels.counts() == ({}, {})


def test_harness_without_gpu_exits_nonzero(monkeypatch, capsys):
    """The harness runs on a GPU only; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kb.main(["leaf"]) != 0
    assert "GPU" in capsys.readouterr().err
    assert kb.main(["nope"]) != 0
    assert set(kb.BENCHES) == {"leaf", "extract", "cond", "ctz", "sweep", "sort", "binned"}


def test_harness_wavefronts_match_the_jax_harness():
    """camera_rays / bounce_rays are bench_sweep's and bench_sort's rays."""
    ro, rd = kb.camera_rays("cpu", 512)
    w, h = 256, 2
    ys, xs = np.mgrid[0:h, 0:w]
    u = (xs.ravel() + 0.5) / w - 0.5
    v = (ys.ravel() + 0.5) / h - 0.5
    rd_j = np.stack([u, np.zeros(512), v], axis=1) - np.array([0.0, 1.2, 1.4], np.float32)
    rd_j /= np.linalg.norm(rd_j, axis=1, keepdims=True)
    np.testing.assert_array_equal(rd.numpy(), rd_j.astype(np.float32))
    assert torch.equal(ro, torch.tensor([[0.0, 1.2, 1.4]]).expand(512, 3))
    ro_b, rd_b = kb.bounce_rays("cpu", 512)
    assert ro_b.shape == rd_b.shape == (512, 3)
    torch.testing.assert_close(rd_b.norm(dim=1), torch.ones(512))


@pytest.mark.parametrize("bad", ["ragged", "dtype", "table"])
def test_wrappers_reject_bad_operands_on_cuda_path(operands, bad):
    """The operand checks the CUDA path runs before a launch."""
    rcol, tri = operands
    if bad == "ragged":
        rcol = rcol[:100]
    elif bad == "dtype":
        rcol = rcol.double()
    else:
        tri = tri[:64]
    with pytest.raises(ValueError):
        kb._check(rcol, tri)


@pytest.mark.cuda
def test_probe_kernels_match_twins_on_gpu(tmp_path):
    """On a CUDA device: each probe kernel's output has its twin's bits on
    every parameter of the harness's lists at 256 tiles, 1, 3 and 300
    tiles (N = 128, 384, 38,400), at 2 tiles in rows 4 bytes past a
    16-byte boundary, and on the edge sets at 0, 1, 7 and 9; on every set
    the extract also at K of 0, 1, 7 and 9 and the ctz at words 0,
    0x80000000 and 0x80000001 (run on the card with `python -m pytest
    tests/test_torch_kernelbench.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bad, _ = cb.probe_parity(kb, cb.probe_sets(torch.device("cuda:0")), tmp_path)
    assert bad == 0


@pytest.mark.cuda
def test_graph_ms_counts_the_launches_that_ran():
    """On a CUDA device: graph_ms counts its warm-up launch and each
    replayed launch, not the captured ones (1 + 2 * reps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rcol, tri = (x.cuda() for x in kb.inputs(kb.N_TILES, "cpu"))
    kb.reset_counters()
    kb.graph_ms(lambda: kb.leaf(rcol, tri, 4), reps=5)
    assert kb.leaf.launches == 1 + 2 * 5 and kb.leaf.twin_calls == 0
    kb.reset_counters()


# a cuobjdump -sass dump in the toolkit's format: an outer loop around an
# inner one whose second half is a slow path with a CALL
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114kb_cond_kernelEPKfS1_iiPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
.L_x_0:
        /*0010*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
.L_x_1:
        /*0020*/                   LDS.128 R4, [R2+0x10] ;
        /*0030*/                   FADD R5, R4, -R8 ;
        /*0040*/                   FMUL R6, R5, R9 ;
        /*0050*/                   FMUL R6, R6, R10 ;
        /*0060*/                   FMNMX R7, R7, R6, PT ;
        /*0070*/              @!P1 BRA `(.L_x_2) ;
        /*0080*/                   BRA `(.L_x_3) ;
.L_x_2:
        /*0090*/                   MOV R4, R5 ;
        /*00a0*/                   CALL.REL.NOINC `($_slow) ;
.L_x_3:
        /*00b0*/               @P2 BRA `(.L_x_1) ;
        /*00c0*/               @P0 BRA `(.L_x_0) ;
        /*00d0*/                   EXIT ;
"""


def test_sass_loops_reads_the_innermost_loop():
    """sass_loops finds the shortest backward branch around a test, counts
    its tests by FMULs and its slow-path block by the CALL in it."""
    loops = cb.sass_loops(_SASS)
    assert set(loops) == {"kb_cond_kernel"}
    loop = loops["kb_cond_kernel"]
    assert loop["instructions"] == 10 and loop["tests"] == 1 and loop["slow"] == 2
    assert loop["per_test"] == 10 and loop["per_test_fast"] == 8
    assert loop["ops"]["FMUL"] == 2 and loop["ops"]["BRA"] == 3
    assert cb.sass_loop_report(_SASS)[0].startswith("sass kb_cond_kernel: innermost loop 10")


def test_probe_sets_and_parameters():
    """kernels probes --parity runs the harness's lists on the harness's
    operands at 256, 1, 3 and 300 tiles and at 2 tiles in offset rows, and
    the edge counts on the edge sets; its bounds are chip_smoke.py phase
    13's."""
    sets = cb.probe_sets("cpu")
    assert {k: v[0].shape[0] for k, v in sets.items()} == {
        "32768 rays": 32768, "128 rays": 128, "384 rays": 384, "38400 rays": 38400,
        "256 rays, offset rows": 256, "ties": 256, "degenerate": 256, "zero direction": 256, "origin on a vertex": 256}
    harness, edge = cb.probe_params("32768 rays"), cb.probe_params("ties")
    assert ("leaf", 64) in harness and ("cond", (64, True)) in harness
    assert [x for p, x in edge if p == "leaf"] == [0, 1, 7, 9]
    assert len([x for p, x in edge if p == "cond"]) == 8
    assert cb.probe_bound("leaf", 64, 32768) == (32768 * 64 * 128 * 60 / 67e12 * 1e3,
                                                 "operations")
    assert cb.probe_bound("cond", (64, False), 32768)[1] == "bytes"
    # every parity set also holds the extract at the edge counts and the
    # ctz at bit 31 and word 0; the timing list stays the harness's
    for params in (harness, edge, cb.probe_params("256 rays, offset rows")):
        assert sorted(x for p, x in params if p == "extract") == [0, 1, 7, 8, 9, 32, 128]
        assert [x for p, x in params if p == "ctz"] == [0x1, 0xF0F0, -1, 0, 0x80000000,
                                                      0x80000001]
    timing = cb.probe_params("harness")
    assert [x for p, x in timing if p == "extract"] == list(kb.EXTRACT_K)
    assert [x for p, x in timing if p == "ctz"] == [w for w, _ in kb.CTZ_WORDS]


# ---------------------------------------------------------------------------
# the extract (B10) and ctz (B12) kernels' orders, and their edge checks
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_word(word):
    """A 32-bit word as the JAX kernel takes it (jnp.int32(word)): bit 31
    as the sign."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


@pytest.mark.parametrize("word", cb.PROBE_WORDS)
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_ctz_twin_equals_pallas_on_edges(edge_sets, label, word):
    """ctz_ref equals _ctz_kernel in interpret mode bit for bit on the edge
    sets at word 0, bit 0, the harness's 8 bits, bit 31 alone and with bit
    0, and all 32 bits (a product has no multiply-add for XLA:CPU to
    contract, so no tolerance is needed)."""
    rcol, tri = edge_sets[label]
    ref = _pallas(partial(kb_jax._ctz_kernel, _jax_word(word)), rcol, tri)
    out = kb.ctz_ref(rcol, tri, word).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert (out == np.float32(kb.MISS)).all() == (word == 0)
    if label == "origin on a vertex" and word:
        assert (out[::2] == 0).all()


@pytest.mark.parametrize("n_ext", cb.PROBE_COUNTS)
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_extract_twin_equals_pallas_on_edges(edge_sets, label, n_ext):
    """extract_ref equals the float32 NumPy evaluation of _extract_kernel
    bit for bit and interpret mode to rtol 1e-3 (XLA:CPU contracts acc +
    s * 1e-20 into an FMA) on the edge sets at K of 0, 1, 7 and 9."""
    rcol, _ = edge_sets[label]
    ref = _pallas(partial(kb_jax._extract_kernel, n_ext), rcol)
    out = kb.extract_ref(rcol, n_ext).numpy()
    np.testing.assert_array_equal(out, _extract_np(rcol, n_ext))
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=0)
    assert (out > 0).all() == (n_ext > 0)


# A model of the ctz kernel's lanes over triangles: lane l keeps a running
# minimum of triangles 4 l .. 4 l + 3 of each set bit's row block, lowest
# bit first; the lanes' minima meet in a butterfly (lane l takes the min of
# its own and lane l ^ d's at d = 16, 8, 4, 2, 1), and ray r of a warp's R
# reads lane 32 / R * r (min_halve: lanes 2 r and 2 r + 1 at R = 16).

def _ctz_lanes(rcol, tri, word, rays=16):
    n = rcol.shape[0]
    o = [rcol[:, c:c + 1] for c in range(3)]
    best = torch.full((n, 32), kb.MISS, dtype=rcol.dtype)
    for c in kb.set_bits(word):
        blk = kb._block(tri, c)
        p = ((blk[0] - o[0]) * (blk[1] - o[1]) * (blk[2] - o[2])).view(-1, 32, 4)
        for k in range(4):
            best = torch.minimum(best, p[:, :, k])
    if word & 0xFFFFFFFF:
        lanes = torch.arange(32)
        for d in (16, 8, 4, 2, 1):
            best = torch.minimum(best, best[:, lanes ^ d])
    lane = 32 // rays * (torch.arange(n) % rays)
    return best[torch.arange(n), lane].unsqueeze(1)


@pytest.mark.parametrize("word", cb.PROBE_WORDS)
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_ctz_lane_split_equals_twin(edge_sets, label, word):
    """The ctz kernel's order (lanes over triangles, 16 rays a warp, the
    lowest bit first, the lanes' exchange) gives ctz_ref's bits, +0 and -0
    told apart, on every edge set and word."""
    rcol, tri = edge_sets[label]
    ref = kb.ctz_ref(rcol, tri, word)
    for rays in (16, 32):
        out = _ctz_lanes(rcol, tri, word, rays)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


# A model of the extract kernel's grouping: lane l of warp w holds float4s
# w * 32 Q + l + 32 q (q < Q) of the tile's 1,024 floats, 4 Q values; a
# round adds acc to each, reduces them with the kernel's max tree (t[k] =
# max(t[k], t[k + h]), h halving), then across the warp (one REDUX on the
# ordered keys, or a butterfly of shuffles), then across the tile's warps
# in order, and adds max * 1e-20 to acc.

def _extract_lanes(rcol, n_ext, per_lane=32, cross="redux"):
    r = rcol.numpy().reshape(-1, kb.RAY_TILE * 8)
    warps, quads = r.shape[1] // (32 * per_lane), per_lane // 4
    w, lane, q, c = np.meshgrid(range(warps), range(32), range(quads), range(4),
                                indexing="ij")
    idx = (4 * (w * 32 * quads + lane + 32 * q) + c).reshape(warps, 32, per_lane)
    vals = r[:, idx]                                      # (tiles, warps, 32, per_lane)
    lanes = np.arange(32)
    acc = np.zeros(r.shape[0], np.float32)
    for _ in range(n_ext):
        t = vals + acc[:, None, None, None]
        h = per_lane // 2
        while h:
            t = np.maximum(t[..., :h], t[..., h:2 * h])
            h //= 2
        m = t[..., 0]                                     # (tiles, warps, 32)
        if cross == "redux":
            m = kb.ordered_value(kb.ordered_key(m).max(axis=2))
        else:
            for d in (16, 8, 4, 2, 1):
                m = np.maximum(m, m[..., lanes ^ d])
            m = m[..., 0]
        s = m[:, 0]
        for u in range(1, warps):
            s = np.maximum(s, m[:, u])
        acc = acc + s * np.float32(1e-20)
    return np.repeat(acc[:, None], kb.RAY_TILE, axis=0)


@pytest.mark.parametrize("n_ext", sorted(set(cb.PROBE_COUNTS) | set(kb.EXTRACT_K)))
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_extract_lane_split_equals_twin(edge_sets, label, n_ext):
    """The extract kernel's grouping (32 values a lane, or 16 in two warps a
    tile) with either cross-lane step gives extract_ref's bits on every
    edge set at every K of PROBE_COUNTS and of the harness's list."""
    rcol, _ = edge_sets[label]
    ref = kb.extract_ref(rcol, n_ext).numpy().view(np.int32)
    for per_lane in (32, 16):
        for cross in ("redux", "shuffle"):
            out = _extract_lanes(rcol, n_ext, per_lane, cross)
            np.testing.assert_array_equal(out.view(np.int32), ref)


def test_ordered_key_is_monotone_and_round_trips(edge_sets):
    """ordered_key (the NumPy mirror of the extract kernel's map) is a
    bijection that sorts like the floats, -0 below +0, on +-0, +-subnormals,
    +-normals, +-inf and every value of the edge sets."""
    tiny = np.finfo(np.float32).tiny
    special = np.array([0.0, 1e-45, tiny / 2, tiny, 1.0, np.finfo(np.float32).max, np.inf],
                       np.float32)
    vals = np.concatenate([special, -special] + [x.numpy().ravel() for r, t in
                                                  edge_sets.values() for x in (r, t)])
    keys = kb.ordered_key(vals)
    assert keys.dtype == np.uint32
    np.testing.assert_array_equal(kb.ordered_value(keys).view(np.uint32), vals.view(np.uint32))
    order = np.argsort(keys, kind="stable")
    assert (np.diff(vals[order]) >= 0).all()
    assert kb.ordered_key(np.float32(-0.0)) < kb.ordered_key(np.float32(0.0))
    assert (np.diff(np.sort(kb.ordered_key(special))) > 0).all()


_LAT = {"INT": 4, "FADD": 4, "FMUL": 4, "FMNMX": 4, "SHFL": 20, "REDUX": 30, "LDS": 30,
        "STS": 10, "BAR": 20}


def test_sass_deps_reads_destinations_and_sources():
    assert cb.sass_deps("SHFL.BFLY PT, R6, R4, 0x10, 0x1f") == (["R6"], ["R4"])
    assert cb.sass_deps("ISETP.NE.AND P0, PT, R11, RZ, PT") == (["P0"], ["R11"])
    assert cb.sass_deps("LDS.64 R4, [R2+0x8]") == (["R4", "R5"], ["R2"])
    assert cb.sass_deps("@!P0 BRA `(.L_x_0)") == ([], ["P0"])
    assert cb.sass_deps("STS [R3], R4") == ([], ["R3", "R4"])
    assert cb.sass_deps("REDUX.MAX UR4, R5") == (["UR4"], ["R5"])
    assert cb.sass_deps("FMNMX R4, R4, -R6.reuse, !PT") == (["R4"], ["R4", "R6"])


def test_round_cycles_follows_the_dependent_chain():
    """round_cycles: a round of two adds, a max, a shuffle, a max, a
    multiply and the add that feeds the next round (the loop's compare
    issued first, as the compiler places it) is 4 + 1 + 4 + 20 + 4 + 4 + 4
    cycles a round; a shared store, a barrier and a load after it add the
    store's, the barrier's and the load's latencies."""
    body = ["ISETP.NE.AND P0, PT, R11, RZ, PT", "FADD R4, R2, R10", "FADD R5, R3, R10",
            "FMNMX R4, R4, R5, !PT", "SHFL.BFLY PT, R6, R4, 0x10, 0x1f",
            "FMNMX R4, R4, R6, !PT", "FMUL R7, R4, 1.0000000200408773e-20",
            "FADD R10, R10, R7", "@P0 BRA `(.L_x_0)"]
    assert cb.round_cycles(body, _LAT) == 41
    shared = body[:6] + ["STS [R12], R4", "BAR.SYNC.DEFER_BLOCKING 0x0", "LDS R4, [R12]"] + body[6:]
    assert cb.round_cycles(shared, _LAT) == 41 + 10 + 20 + 30
    loops = {"kb_extract_kernel": {"body": body, "tests": 1}}
    ms, cyc = cb.extract_floor(loops, _LAT, 128, 2000)
    assert cyc == 41 and ms == pytest.approx(128 * 41 / 2e9 * 1e3)
    # a loop unrolled by two: two rounds a trip
    loops = {"kb_extract_kernel": {"body": body[1:8] + body, "tests": 2}}
    assert cb.extract_floor(loops, _LAT, 128, 2000)[1] == 41


def test_chain_latencies_solve_each_class_in_order():
    """chain_latencies takes each chain's cycles less its known
    instructions' over its new class's count."""
    ops = {"key": {"INT": 512}, "fadd": {"FADD": 256}, "fmul": {"FMUL": 256},
           "shfl": {"SHFL": 256}, "lds": {"LDS": 256}, "fadd+fmax": {"FADD": 256, "FMNMX": 256},
           "redux": {"REDUX": 256, "INT": 256}, "sts+lds": {"STS": 256, "LDS": 256},
           "bar": {"BAR": 256}}
    cycles = {k: sum(_LAT[c] * n for c, n in v.items()) for k, v in ops.items()}
    assert cb.chain_latencies(cycles, ops) == pytest.approx(_LAT)
    with pytest.raises(RuntimeError):
        cb.chain_latencies(cycles, dict(ops, lds={}))


@pytest.mark.parametrize("change", ["value", "sign of zero"])
def test_compare_probes_finds_a_difference(change):
    """compare finds a ray on which two runs' outputs differ, by value or
    only in the sign of a zero."""
    rcol, tri = kb.inputs(1, "cpu")
    out = kb.cond_ref(rcol, tri, 4, True)
    out[5] = 0.0
    a = {"x": {"operands": (rcol, tri), ("cond", (4, True)): out}}
    b = {"x": {"operands": (rcol, tri), ("cond", (4, True)): out.clone()}}
    assert cb.compare_probes(a, b)
    if change == "value":
        b["x"][("cond", (4, True))][3] = 1.0
    else:
        b["x"][("cond", (4, True))][5] = -0.0
    assert not cb.compare_probes(a, b)


@pytest.mark.parametrize("change", ["none", "value", "sign of zero"])
def test_compare_frames_finds_a_difference(change):
    """compare's frames (clusterbench frames) differ when one pixel differs
    in any bit, a zero's sign included."""
    img = torch.rand(4, 5, 3, generator=torch.Generator().manual_seed(0))
    img[1, 2, 0] = 0.0
    a = {f"{e} {n}": img.clone() for e, n in cb.FRAMES}
    b = {k: v.clone() for k, v in a.items()}
    if change == "value":
        b["pbrt 8"][3, 4, 2] += 1e-7
    elif change == "sign of zero":
        b["pbrt 8"][1, 2, 0] = -0.0
    assert cb.compare_frames(a, b) == (change == "none")


def test_offset_rows_start_off_a_16_byte_boundary():
    """probe_sets' offset rows: the same values, contiguous, 4 bytes past a
    16-byte boundary; the wrappers' operand check accepts them and the
    twins give the aligned rows' results."""
    rcol, tri = kb.inputs(2, "cpu")
    view = cb.offset_rows(rcol)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous() and torch.equal(view, rcol)
    assert kb._check(view, tri) == 256
    assert torch.equal(kb.cond_ref(view, tri, 9, True), kb.cond_ref(rcol, tri, 9, True))
    assert torch.equal(kb.leaf_ref(view, tri, 2), kb.leaf_ref(rcol, tri, 2))
