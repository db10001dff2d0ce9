"""perf/glue2.py's stages in pyrenderer_tpu_torch.perf.glue2 against their
JAX counterparts on the CPU: the same inputs (the JAX harness's draws from
numpy.random.default_rng(0), 1,024 rays, small fetch tables) through each
stage of the port and through the JAX package's public functions."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.accel import clusters as clj
from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.kernels import pallas_cluster as pc
from pyrenderer_tpu.scene.procgen import big_scene_data, terrain
from pyrenderer_tpu.scene.tungsten import build_scene
from pyrenderer_tpu_torch.perf import glue2
from tests.torch_fixtures import private_jax_native_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

N = 1024
ROWS = (300, 5000)
WIN, WIN_CHUNK = 1024, 128


@pytest.fixture(scope="module")
def setup():
    x = glue2.inputs("cpu", N, ROWS)
    h = x.host
    cs = clj.build_clusters(*terrain(glue2.TERRAIN_RES))
    host, _, _ = build_scene(big_scene_data("terrain", res=glue2.TERRAIN_RES), dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, host)
    j = dict(cs=cs, scene=scene, keys=jnp.asarray(h["keys"]), ro=jnp.asarray(h["ro"]),
             rd=jnp.asarray(h["rd"]), perm=jnp.asarray(h["perm"]))
    return x, j


def test_inputs_are_the_jax_harness_draws(setup):
    x, _ = setup
    rng = np.random.default_rng(0)
    assert np.array_equal(x.host["keys"], rng.integers(0, 2**31, N).astype(np.uint32))
    assert np.array_equal(x.ro.numpy(), rng.uniform(-1, 1, (N, 3)).astype(np.float32))
    assert x.keys.dtype == torch.int32 and np.array_equal(x.keys.numpy(), x.host["keys"])


def test_sorts_bit_for_bit(setup):
    """The stable argsort and the sorted keys (int32 here, uint32 in JAX:
    the keys are below 2^31)."""
    x, j = setup
    assert np.array_equal(glue2.argsort(x.keys).numpy(), np.asarray(jnp.argsort(j["keys"])))
    assert np.array_equal(glue2.sortu32(x.keys).numpy().astype(np.uint32),
                          np.asarray(jnp.sort(j["keys"])))


def test_keys_bit_for_bit(setup):
    x, j = setup
    got = glue2.keys(x.cs, x.ro, x.rd).numpy()
    want = np.asarray(clj.sort_keys(j["cs"], j["ro"], j["rd"]))
    assert got.dtype == np.int64 and np.array_equal(got, want.astype(np.int64))


def test_permute_bit_for_bit(setup):
    x, j = setup
    ro, rd, perm = j["ro"], j["rd"], j["perm"]
    ro2, rd2 = ro[perm], rd[perm]
    inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(N, dtype=jnp.int32))
    want = np.asarray(ro2[inv] + rd2[inv])
    assert np.array_equal(glue2.permute(x.ro, x.rd, x.perm).numpy(), want)


def test_packrays_equals_the_jax_column_form(setup):
    x, j = setup
    _, cols = pc._pack_rays(j["ro"], j["rd"], jnp.full((N,), glue2.T1, jnp.float32))
    assert np.array_equal(glue2.packrays(x.cs, x.ro, x.rd, x.t1v).numpy(), np.asarray(cols))


def _onehot_jax(tb, ix, chunk):
    rows = tb.shape[0]
    return jnp.concatenate([
        jnp.dot(jax.nn.one_hot(ix[s:s + chunk], rows, dtype=jnp.float32), tb,
                precision=jax.lax.Precision.HIGHEST)
        for s in range(0, ix.shape[0], chunk)])


@pytest.mark.parametrize("which", [0, 1])
def test_take_and_onehot_bit_for_bit(setup, which):
    """take and the one-hot product (in chunks of 256 rays here) return the
    same rows, bit for bit, and each equals its JAX counterpart (jnp.take;
    one_hot @ table at Precision.HIGHEST)."""
    x, _ = setup
    table, idx = x.tables[which]
    tb, ix = (jnp.asarray(a) for a in x.host["tables"][which])
    take = glue2.take(table, idx).numpy()
    hot = glue2.onehot(table, idx, chunk=256).numpy()
    assert np.array_equal(take, hot)
    assert np.array_equal(take, np.asarray(jnp.take(tb, ix, axis=0)))
    assert np.array_equal(hot, np.asarray(_onehot_jax(tb, ix, 256)))


def test_window_bit_for_bit(setup):
    """The windowed one-hot fetch of the sorted indices (a 1,024-row window a
    chunk of 128 here) against the JAX harness's windowed closure, and the
    rows inside each chunk's window against take."""
    x, _ = setup
    got = glue2.window(x.table_w, x.idx_w, WIN, WIN_CHUNK).numpy()
    tb, ix = jnp.asarray(x.host["table_w"]), jnp.asarray(x.host["idx_w"])
    rows = tb.shape[0]
    outs, inside = [], []
    for s in range(0, N, WIN_CHUNK):
        sl = ix[s:s + WIN_CHUNK]
        base = jnp.clip(sl[0], 0, rows - WIN)
        wtab = jax.lax.dynamic_slice_in_dim(tb, base, WIN, axis=0)
        outs.append(jnp.dot(jax.nn.one_hot(sl - base, WIN, dtype=jnp.float32), wtab,
                            precision=jax.lax.Precision.HIGHEST))
        inside.append(np.asarray((sl - base) < WIN))
    assert np.array_equal(got, np.asarray(jnp.concatenate(outs)))
    inside = np.concatenate(inside)
    assert inside.mean() > 0.9
    take = glue2.take(x.table_w, x.idx_w).numpy()
    assert np.array_equal(got[inside], take[inside]) and not got[~inside].any()


def test_wrap_full_and_bare_match_the_jax_sweep(setup):
    """The sorted closest_hit's t (the sweep twin here) against JAX's
    closest_hit_ref at tests/test_torch_cluster.py's bounds (equal hit
    masks, t rtol 1e-4); the bare sweep on _operands' unsorted rays hits the
    same rays, and _operands' supercluster rank is JAX's _sc_order."""
    x, j = setup
    t = glue2.wrap_full(x.cs, x.ro, x.rd, x.t1v).numpy()
    h_j, t_j, _ = (np.asarray(a) for a in clj.closest_hit_ref(j["cs"], j["ro"], j["rd"],
                                                               glue2.T0, glue2.T1))
    assert h_j.any() and np.array_equal(t > 0, h_j)
    np.testing.assert_allclose(t[h_j], t_j[h_j], rtol=1e-4)
    bare = glue2.wrap_bare(x.cs, x.ops).numpy()
    assert np.array_equal(bare > 0, h_j)
    order_j, _ = pc._sc_order(j["cs"], j["ro"])
    assert np.array_equal(x.ops[2].numpy(), np.asarray(order_j))


def test_bounce4x_matches_jax(setup):
    """The 4-bounce trace with the JAX harness's stub on terrain res 64:
    at most 2% of the rays differ at rtol 1e-4, atol 1e-6 (the integrator
    tests' criterion)."""
    x, j = setup
    got = glue2.bounce4x(x.scene, x.cfg, x.stub, x.ro, x.rd, x.pixel_id, x.sample_id).numpy()
    cfg = JaxConfig(max_bounces=4, spp=1, seed=0)
    tables = integ_jax.TraceTables(j["scene"], cfg, "brute")
    nt = j["scene"].faces.shape[0]
    stub = integ_jax.TraceTables.custom(
        tables.face_data, tables.light_data,
        lambda ro, rd, t1: (jnp.ones(ro.shape[0], bool), jnp.full(ro.shape[0], 0.5, ro.dtype),
                            jnp.arange(ro.shape[0], dtype=jnp.int32) % nt),
        lambda ro, rd, t1: jnp.zeros(ro.shape[0], bool))
    want = np.asarray(integ_jax.trace_reference(
        j["scene"], cfg, j["ro"], j["rd"], jnp.arange(N, dtype=jnp.uint32),
        jnp.zeros(N, jnp.uint32), 0, tables=stub))
    assert float(np.abs(want).max()) > 0.01
    assert int((~np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=1)).sum()) <= 0.02 * N


def test_main_on_the_cpu_prints_every_row(capsys):
    """Every row (the fetch tables at their full 8,204 and 100,364 rows) and
    one JSON line; the sorted closest_hit runs the sweep's twin once a call."""
    assert glue2.main(["--device", "cpu", "--n", "256", "--reps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    names = ["argsort", "sortu32", "keys", "permute", "packrays", "take8k", "onehot8k",
             "take100k", "onehot100k", "window100k", "wrap_full", "wrap_bare", "bounce4x"]
    for name in names:
        assert any(line.startswith(name + " ") for line in out), name
    result = json.loads(out[-1])
    assert [r["name"] for r in result["rows"]] == names
    rows = {r["name"]: r for r in result["rows"]}
    assert rows["wrap_full"]["twin_calls"] == {"cluster_closest_hit": 1}
    assert all(r["launches"] == {} for r in result["rows"])
    assert [glue2.kind(n) for n in ("take8k", "onehot100k", "window100k", "sortu32")] == \
        ["take", "onehot", "window", "sortu32"]
