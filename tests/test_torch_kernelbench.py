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
def test_probe_kernels_match_twins_on_gpu(operands):
    """On a CUDA device: each probe kernel equals its twin bit for bit on
    every parameter of the harness's lists (run on the card with
    `python -m pytest tests/test_torch_kernelbench.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rcol, tri = (x.cuda() for x in kb.inputs(kb.N_TILES, "cpu"))
    for n_leaves in kb.LEAF_L:
        assert torch.equal(kb.leaf(rcol, tri, n_leaves), kb.leaf_ref(rcol, tri, n_leaves))
    for n_ext in kb.EXTRACT_K:
        assert torch.equal(kb.extract(rcol, n_ext), kb.extract_ref(rcol, n_ext))
    for n_conds in kb.COND_N:
        for taken in (False, True):
            assert torch.equal(kb.cond(rcol, tri, n_conds, taken),
                               kb.cond_ref(rcol, tri, n_conds, taken))
    for word, _ in kb.CTZ_WORDS:
        assert torch.equal(kb.ctz(rcol, tri, word), kb.ctz_ref(rcol, tri, word))


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
