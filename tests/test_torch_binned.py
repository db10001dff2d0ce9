"""pyrenderer_tpu_torch binned traversal (backends "cluster_binned" and
"cluster_streamed"): routing, the twins of the four binned kernels against
the TPU kernels run in interpret mode, the public queries against the JAX
package and, bit for bit, against the port's own sweep twin, and render_image
end to end."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyrenderer_tpu.accel import clusters as clj
from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.kernels import pallas_binned as pb
from pyrenderer_tpu.kernels import pallas_cluster as pc
from pyrenderer_tpu_torch.accel import clusters as cl
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.core.camera import generate_rays
from pyrenderer_tpu_torch.kernels import binned as kb
from pyrenderer_tpu_torch.kernels import cluster as kc
from pyrenderer_tpu_torch.perf import clusterbench as cb
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from tests.torch_fixtures import private_jax_native_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

T0, T1 = 1e-5, 1e5
CFG = RenderConfig(max_bounces=3, spp=2, seed=3, estimator="reference")
CFG_JAX = JaxConfig(max_bounces=3, spp=2, seed=3, estimator="reference")


def _scene(res):
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=res))
    return host, camera, cl.build_clusters(host.vertices, host.faces), \
        clj.build_clusters(host.vertices, host.faces)


@pytest.fixture(scope="module")
def terrain64():
    """The 8,204-triangle scene of tests/test_binned.py: 80 clusters, 20
    bins, one crossing word."""
    return _scene(64)


@pytest.fixture(scope="module")
def terrain96():
    """18,444 triangles: 160 clusters, 40 bins, two crossing words, so bin
    31 (bit 31 of word 0, a negative int32) is in play."""
    return _scene(96)


def _random_rays(n, seed):
    """Rays inside the box, as tests/test_binned.py makes them."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _ray_set(name, scene=None):
    """(ro, rd, t1) of a named ray set: t1 is a scalar or an (N,) array.
    "camera" takes 256 random pixels of `scene`'s camera."""
    if name == "camera":
        rs = np.random.RandomState(0)
        _, camera = to_device(scene[0], scene[1], "cpu")
        w, h = camera.resolution
        ro, rd = generate_rays(camera, torch.from_numpy(rs.randint(0, w, 256)),
                               torch.from_numpy(rs.randint(0, h, 256)), 1, CFG.seed)
        return ro.numpy(), rd.numpy(), T1
    n = 300 if name == "ragged" else 256
    ro, rd = _random_rays(n, {"random": 3, "ragged": 5, "per_ray_t1": 9, "dead_lanes": 13}[name])
    if name == "per_ray_t1":
        return ro, rd, np.random.RandomState(1).uniform(0.1, 3.0, n).astype(np.float32)
    if name == "dead_lanes":
        return ro, rd, np.where(np.arange(n) % 3 == 0, 0.0, T1).astype(np.float32)
    return ro, rd, T1


def _t(t1):
    return t1 if np.isscalar(t1) else torch.from_numpy(t1)


def _j(t1):
    return t1 if np.isscalar(t1) else jnp.asarray(t1)


def _port_rays(cs, ro, rd, t1):
    return kc._prepare(cs, torch.from_numpy(ro), torch.from_numpy(rd), _t(t1), sort=False)[0]


def _jax_lane(ro, rd, t1):
    """The JAX kernels' operands: rays padded to 128 * SUB, lane and column
    forms."""
    ro_p, rd_p, t1v, _ = pb._pad_rays(jnp.asarray(ro), jnp.asarray(rd), _j(t1))
    return pc._pack_rays(ro_p, rd_p, t1v)


def _words_ray_major(words, n_words):
    """JAX's lane-layout words (tiles * n_words, 128) -> (N_pad, n_words)."""
    w = np.asarray(words)
    tiles = w.shape[0] // n_words
    return w.reshape(tiles, n_words, 128).transpose(0, 2, 1).reshape(tiles * 128, n_words)


def _words_lane(words):
    """The inverse of _words_ray_major, (N_pad, n_words) -> lane layout."""
    n, n_words = words.shape
    return jnp.asarray(words.reshape(n // 128, 128, n_words).transpose(0, 2, 1)
                       .reshape(-1, 128))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_routing_honours_cluster_impl_binned(monkeypatch, terrain64):
    """PYRENDERER_CLUSTER_IMPL=binned turns "cluster", and "auto" past
    AUTO_BRUTE_MAX_TRIS on CUDA, into "cluster_binned", as the JAX package
    does (core/integrator.py:178-179, :204); CPU "auto" stays "bvh" there,
    as off the TPU; the binned backends resolve to themselves, and "auto"
    never picks "cluster_streamed"."""
    limit = integ.AUTO_BRUTE_MAX_TRIS
    monkeypatch.setenv("PYRENDERER_CLUSTER_IMPL", "binned")
    for dev in ("cpu", "cuda:0"):
        assert integ.resolve_backend("cluster", 36, dev) == "cluster_binned"
        assert integ.resolve_backend("auto", limit, dev) in ("brute", "cuda")
        for b in ("cluster_binned", "cluster_streamed"):
            assert integ.resolve_backend(b, 36, dev) == b
    assert integ.resolve_backend("auto", limit + 1, "cuda:0") == "cluster_binned"
    assert integ.resolve_backend("auto", limit + 1, "cpu") == "bvh"
    host, camera, _, _ = terrain64
    scene, _ = to_device(host, camera, "cpu")
    accel = integ.maybe_build_accel(scene, "cluster")
    assert isinstance(accel, cl.ClusterScene) and accel.bin_box.shape == (32, 128)
    tables = integ.TraceTables(scene, CFG, "cluster", accel=accel)
    assert tables.backend == "cluster_binned" and not tables.cluster_sort
    monkeypatch.delenv("PYRENDERER_CLUSTER_IMPL")
    for n_tris in (36, limit + 1, 10 ** 6):
        for dev in ("cpu", "cuda:0"):
            assert integ.resolve_backend("auto", n_tris, dev) != "cluster_streamed"
    assert integ.resolve_backend("auto", limit + 1, "cuda:0") == "cluster"
    assert integ.resolve_backend("cluster", 36, "cpu") == "cluster"
    for b in ("cluster_binned", "cluster_streamed"):
        assert integ.resolve_backend(b, 36, "cpu") == b
        assert isinstance(integ.maybe_build_accel(scene, b), cl.ClusterScene)
        tables = integ.TraceTables(scene, CFG.replace(cluster_watertight=True), b)
        assert tables.backend == b and tables.cluster_watertight and not tables.cluster_sort


def test_cli_backend_cluster_binned_writes_png(cornell_path, tmp_path):
    """The CLI's --backend cluster_binned on the CPU (the kernels' twins)."""
    png = tmp_path / "binned.png"
    kb.reset_counters()
    rc = cli.main([cornell_path, "--cpu", "--res", "16", "16", "--spp", "1", "--depth", "3",
                   "--estimator", "reference", "--backend", "cluster_binned",
                   "--out", str(png), "--quiet"])
    assert rc == 0 and png.stat().st_size > 0
    assert kb.prepass.twin_calls == 6 and kb.prepass.launches == 0
    kb.reset_counters()


# ---------------------------------------------------------------------------
# each twin against its TPU kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [6, 2, 1])
def test_prepass_twin_matches_pallas_interpret(terrain96, w):
    """prepass_ref bit-equal to pb._prepass_call(emit_words=True): ids,
    overflow and the words left, with scalar and per-ray t1 (dead lanes
    included) on a ragged N = 300."""
    _, _, cs, cs_j = terrain96
    n = 300
    ro, rd = _random_rays(n, 21)
    rd[:4] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [0.1, -0.2, 0.97]]
    t1_ray = np.random.RandomState(2).uniform(0.1, 3.0, n).astype(np.float32)
    t1_ray[::4] = 0.0
    n_words = cs.bin_box.shape[0] // 32
    assert n_words == 2
    for t1 in (T1, t1_ray):
        ids, ovf, words = kb.prepass_ref(cs, _port_rays(cs, ro, rd, t1), T0, w, emit_words=True)
        lane, _ = _jax_lane(ro, rd, t1)
        ids_j, ovf_j, words_j = pb._prepass_call(cs_j, lane, T0, w, True, emit_words=True)
        assert ids.dtype == torch.int32 and words.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j)[:n])
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j)[:n])
        np.testing.assert_array_equal(words.numpy(), _words_ray_major(words_j, n_words)[:n])
        assert (ids.numpy() != kb.SENTINEL).any()
    # bit 31: bin 31 crosses for some ray, so some word is negative
    bits = kb.prepass_ref(cs, _port_rays(cs, ro, rd, T1), T0, 1, emit_words=True)
    assert ((bits[0][:, 0] == 31) | (bits[2][:, 0] < 0)).any()
    # dead lanes (t1 = 0) have no candidate at all
    ids_dead = kb.prepass_ref(cs, _port_rays(cs, ro, rd, t1_ray), T0, w)[0]
    assert (ids_dead[::4] == kb.SENTINEL).all()


@pytest.mark.parametrize("w", [2, 1])
def test_peel_twin_matches_pallas_interpret(terrain96, w):
    """peel_ref bit-equal to pb._peel_call over two residual rounds."""
    _, _, cs, cs_j = terrain96
    ro, rd = _random_rays(300, 22)
    lane, _ = _jax_lane(ro, rd, T1)
    _, _, words_j = pb._prepass_call(cs_j, lane, T0, w, True, emit_words=True)
    words = torch.from_numpy(_words_ray_major(words_j, 2).copy())
    for _ in range(2):
        ids, ovf, words = kb.peel_ref(words, w)
        ids_j, ovf_j, words_j = pb._peel_call(cs_j, words_j, w, True)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
        np.testing.assert_array_equal(words.numpy(), _words_ray_major(words_j, 2))
        assert (ids.numpy() != kb.SENTINEL).any()
    np.testing.assert_array_equal(np.asarray(_words_lane(words.numpy())), np.asarray(words_j))


# t1 of every ray of a dead-ray edge set; only "t1 = t0" and "t1 inf" are live
# (t1 >= t0): the slab test accepts t_near <= min(t_far, t1) and t_near is
# at least t0 or NaN, so no box crosses where !(t1 >= t0)
DEAD_EDGES = {
    "t1 = t0": np.float32(T0),
    "t1 below t0": np.nextafter(np.float32(T0), np.float32(0)),
    "t1 NaN": np.float32(np.nan),
    "t1 inf": np.float32(np.inf),
    "t1 zero": np.float32(0.0),
    "t1 negative": np.float32(-1.0),
}


@pytest.mark.parametrize("emit_words", [False, True])
@pytest.mark.parametrize("edge", list(DEAD_EDGES))
def test_prepass_dead_ray_rule_matches_pallas_interpret(terrain96, edge, emit_words):
    """The rule the prepass kernel skips rays by, !(t1 >= t0), against
    prepass_ref and pb._prepass_call in interpret mode, bit for bit: with
    t1 exactly t0 a ray whose origin lies inside a bin's box crosses it (so
    the whole-table kernels' !(t1 > t0) would be wrong here); one float
    below t0, NaN, 0 or negative, no ray has a candidate, an overflow or a
    bit left. Half of the 300 origins are centres of real bins' boxes."""
    _, _, cs, cs_j = terrain96
    n = 300
    ro, rd = _random_rays(n, 23)
    box = cs.bin_box8[:, :6].numpy()
    real = box[np.isfinite(box).all(axis=1)]
    ro[::2] = (0.5 * (real[:, :3] + real[:, 3:]))[np.arange(n - n // 2) % real.shape[0]]
    t1 = np.full(n, DEAD_EDGES[edge], np.float32)
    out = kb.prepass_ref(cs, _port_rays(cs, ro, rd, t1), T0, 6, emit_words=emit_words)
    lane, _ = _jax_lane(ro, rd, t1)
    out_j = pb._prepass_call(cs_j, lane, T0, 6, True, emit_words=emit_words)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(out_j[0])[:n])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(out_j[1])[:n])
    if emit_words:
        np.testing.assert_array_equal(out[2].numpy(), _words_ray_major(out_j[2], 2)[:n])
    crossed = out[0].numpy() != kb.SENTINEL
    if t1[0] >= np.float32(T0):
        assert crossed[::2].any(axis=1).all()
    else:
        assert not crossed.any() and not out[1].any()
        assert not emit_words or not out[2].any()


@pytest.mark.parametrize("w", [1, 6, 10])
def test_peel_twin_matches_pallas_interpret_on_edge_words(terrain96, w):
    """peel_ref bit-equal to pb._peel_call over three rounds on words with
    bit 31 set (INT32_MIN, which the TPU kernel special-cases), full words,
    and fewer set bits than W (clusterbench.edge_words)."""
    _, _, _, cs_j = terrain96
    words = torch.from_numpy(cb.edge_words(1024, 2))
    words_j = _words_lane(words.numpy())
    for k in range(3):
        ids, ovf, words = kb.peel_ref(words, w)
        ids_j, ovf_j, words_j = pb._peel_call(cs_j, words_j, w, True)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
        np.testing.assert_array_equal(words.numpy(), _words_ray_major(words_j, 2))
        if k == 0:   # bit 31 of either word is bin 31 or 63
            assert (ids[:16, 0] == 31).all() and (ids[16:32, 0] == 63).all()
            expect = ([0, 2] + [kb.SENTINEL] * w)[:w]   # word 0b101: fewer bits than W
            assert (ids[96:112] == torch.tensor(expect, dtype=torch.int32)).all()


@pytest.mark.parametrize("which", ["terrain64", "terrain96"])
def test_bin_box8_is_bin_box_compact(which, terrain64, terrain96):
    """The prepass kernel's compact box copy: bin_box's first BOX_ROW lanes
    (the box in 0..5, zeros in 6..7, NaN boxes on the padding rows), a
    multiple of 32 rows, contiguous; ClusterScene.to carries it."""
    cs = (terrain64 if which == "terrain64" else terrain96)[2]
    small = cs.bin_box8
    assert small.shape == (cs.bin_box.shape[0], cl.BOX_ROW) and small.shape[0] % 32 == 0
    assert small.dtype == torch.float32 and small.is_contiguous()
    torch.testing.assert_close(small, cs.bin_box[:, :cl.BOX_ROW], rtol=0, atol=0,
                               equal_nan=True)
    assert not small[:, 6:].any()
    kb_real = cs.n_clusters // cl.BIN
    assert torch.isnan(small[kb_real:, :6]).all()
    moved = cs.to(torch.device("meta"))
    assert moved.bin_box8.device.type == "meta" and moved.bin_box8.shape == small.shape
    back = cs.to(torch.device("cpu"))
    torch.testing.assert_close(back.bin_box8, small, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("watertight", [False, True])
def test_leaf_twin_matches_pallas_interpret(terrain96, watertight):
    """leaf_ref against pb._leaf_call on the same sorted pairs. JAX keys
    decode as t = key & ~511, index in bin = key & 511. Equal hit masks,
    slots equal on > 0.995 of hits, t within 2^-13 relative (the packed key
    drops 9 mantissa bits, and XLA:CPU contracts FMAs, ROADMAP §C)."""
    _, _, cs, cs_j = terrain96
    ro, rd, t1 = _ray_set("per_ray_t1")
    rays = _port_rays(cs, ro, rd, t1)
    ids, ovf = kb.prepass_ref(cs, rays, T0, 6)
    n_real = int((ids != kb.SENTINEL).sum())
    sortd, pair_ray = kb.sort_pairs(ids, n_real)
    keys = kb.leaf_ref(cs, sortd, pair_ray, rays, T0, watertight)
    hit, t, slot = kb.decode(keys)
    assert torch.equal(hit, keys != kb.MISS_KEY) and hit.any()

    p_pad = -(-n_real // (pb.BPS * 128)) * (pb.BPS * 128)
    sortd_j = np.full(p_pad, pb.SENTINEL, np.int32)
    sortd_j[:n_real] = sortd.numpy()
    prcol = np.zeros((p_pad, 8), np.float32)
    prcol[:n_real] = rays[pair_ray].numpy()
    keys_j = np.asarray(pb._leaf_call(cs_j, jnp.asarray(sortd_j), jnp.asarray(prcol), T0,
                                      watertight, True))[:n_real]
    hit_j = keys_j < pb.MISS_KEY
    t_j = (keys_j & ~np.int32(511)).view(np.float32)
    slot_j = sortd_j[:n_real] * pb.BIN_TRIS + (keys_j & 511)
    np.testing.assert_array_equal(hit.numpy(), hit_j)
    h = hit.numpy()
    assert (slot.numpy()[h] == slot_j[h]).mean() > 0.995
    np.testing.assert_allclose(t.numpy()[h], t_j[h], rtol=2.0 ** -13)
    assert (slot.numpy()[~h] == -1).all()


def _jax_leaf_slots(cs_j, sortd, pair_ray, rays, watertight):
    """pb._leaf_call in interpret mode on the port's sorted pairs: (hit,
    slot) per pair, decoded as test_leaf_twin_matches_pallas_interpret
    decodes them."""
    n = sortd.shape[0]
    p_pad = -(-n // (pb.BPS * 128)) * (pb.BPS * 128)
    sortd_j = np.full(p_pad, pb.SENTINEL, np.int32)
    sortd_j[:n] = sortd.numpy()
    prcol = np.zeros((p_pad, 8), np.float32)
    prcol[:n] = rays[pair_ray].numpy()
    keys_j = np.asarray(pb._leaf_call(cs_j, jnp.asarray(sortd_j), jnp.asarray(prcol), T0,
                                      watertight, True))[:n]
    return keys_j < pb.MISS_KEY, sortd_j[:n] * pb.BIN_TRIS + (keys_j & 511)


@pytest.mark.parametrize("watertight", [False, True])
def test_leaf_twins_resolve_duplicates_to_lowest_slot(terrain64, watertight):
    """Exact duplicate triangles in one bin (clusterbench.DUPLICATES: across
    a warp's lane split at 31/32 and 63/64, within one lane at 95/127,
    across the bin's clusters 0 and 3): every ray aimed at a source
    triangle hits it at the lower slot, never the copy, in leaf_ref,
    leaf_streamed_ref and pb._leaf_call in interpret mode alike."""
    import dataclasses

    _, _, cs, cs_j = terrain64
    cs_d, rays, sortd, pair_ray, copies, sources = cb.duplicate_set(cs, "cpu")
    cs_dj = dataclasses.replace(cs_j, tri=jnp.asarray(cs_d.tri.numpy()))
    keys = kb.leaf_ref(cs_d, sortd, pair_ray, rays, T0, watertight)
    blocks = kb.blocks_for(sortd, cs.n_clusters // cl.BIN)
    assert torch.equal(kb.leaf_streamed_ref(cs_d, blocks, pair_ray, rays, T0, watertight), keys)
    hit, _, slot = kb.decode(keys)
    assert hit.all()
    per_source = slot.reshape(len(sources), -1)
    for k, (src, dst) in enumerate(zip(sources, copies)):
        assert (per_source[k] == src).all(), (src, per_source[k])
        assert not (slot == dst).any()
    hit_j, slot_j = _jax_leaf_slots(cs_dj, sortd, pair_ray, rays, watertight)
    np.testing.assert_array_equal(hit_j, hit.numpy())
    np.testing.assert_array_equal(slot_j, slot.numpy())


@pytest.fixture(scope="module")
def edge_streams(terrain64):
    """clusterbench.edge_streams of 256 random rays on terrain 64."""
    _, _, cs, _ = terrain64
    ro, rd, t1 = _ray_set("random")
    streams = cb.edge_streams(kb, cs, _port_rays(cs, ro, rd, t1))
    assert tuple(streams) == cb.EDGE_STREAMS
    return streams


@pytest.mark.parametrize("label", cb.EDGE_STREAMS)
def test_leaf_twins_agree_on_launch_edges(terrain64, edge_streams, label):
    """The launch edges of the binned leaves (one pair, 33, a bin of more
    than 128, a last piece of one pair, all SENTINEL, dead rays): both
    twins give the same key on every pair, MT and watertight, the streamed
    one through blocks_for's pieces; SENTINEL and dead pairs miss."""
    _, _, cs, _ = terrain64
    sortd, pair_ray, rays = edge_streams[label]
    n_bins = cs.n_clusters // cl.BIN
    blocks = kb.blocks_for(sortd, n_bins)
    counts = blocks[blocks[:, 0] >= 0, 2]
    assert counts.sum() == (0 if label == "all SENTINEL" else sortd.shape[0])
    if label == "the largest bin":
        assert sortd.shape[0] > 128 and (sortd == sortd[0]).all() and counts.shape[0] >= 2
    if label == "last piece of one pair":
        assert counts.tolist() == [kb.RUN_PAIRS] * (128 // kb.RUN_PAIRS) + [1]
    for wt in (False, True):
        keys = kb.leaf_ref(cs, sortd, pair_ray, rays, T0, wt)
        assert torch.equal(kb.leaf_streamed_ref(cs, blocks, pair_ray, rays, T0, wt), keys)
        if label in ("all SENTINEL", "dead rays"):
            assert (keys == kb.MISS_KEY).all()
        elif sortd.shape[0] > 128:
            assert (keys != kb.MISS_KEY).any()


@pytest.mark.parametrize("w", [6, 1])
@pytest.mark.parametrize("watertight", [False, True])
def test_wrappers_match_pallas_interpret(terrain64, monkeypatch, watertight, w):
    """The public closest_hit / occluded (resident, their twins on CPU
    tensors) against pb.closest_hit / pb.occluded in interpret mode, with
    tests/test_binned.py's bounds: equal hits, faces > 0.995, t rtol 1e-4,
    equal occlusion. W = 1 sends most rays through the sweep residual."""
    _, _, cs, cs_j = terrain64
    monkeypatch.setattr(kb, "W_SLOTS", w)
    monkeypatch.setattr(pb, "W_SLOTS", w)
    ro, rd, t1 = _ray_set("per_ray_t1")
    h, t, face = (x.numpy() for x in kb.closest_hit(
        cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, _t(t1), watertight=watertight))
    h_j, t_j, face_j = (np.asarray(x) for x in pb.closest_hit(
        cs_j, jnp.asarray(ro), jnp.asarray(rd), T0, _j(t1), watertight=watertight,
        interpret=True))
    assert h.any() and np.array_equal(h, h_j)
    assert (face[h] == face_j[h]).mean() > 0.995
    np.testing.assert_allclose(t[h], t_j[h], rtol=1e-4)
    assert np.all(face[~h] == 0) and np.all(t[~h] == 0)
    occ = kb.occluded(cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, _t(t1),
                      watertight=watertight).numpy()
    occ_j = np.asarray(pb.occluded(cs_j, jnp.asarray(ro), jnp.asarray(rd), T0, _j(t1),
                                   watertight=watertight, interpret=True))
    assert np.array_equal(occ, occ_j)


def test_streamed_wrapper_matches_pallas_interpret(terrain64):
    """The streamed closest hit against pb.closest_hit(streamed=True) in
    interpret mode, once (it is slow there): 256 rays, MT leaves, the
    streamed default W = 10 on both sides."""
    _, _, cs, cs_j = terrain64
    ro, rd, t1 = _ray_set("random")
    h, t, face = (x.numpy() for x in kb.closest_hit(
        cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, t1, streamed=True))
    h_j, t_j, face_j = (np.asarray(x) for x in pb.closest_hit(
        cs_j, jnp.asarray(ro), jnp.asarray(rd), T0, t1, streamed=True, interpret=True))
    assert h.any() and np.array_equal(h, h_j)
    assert (face[h] == face_j[h]).mean() > 0.995
    np.testing.assert_allclose(t[h], t_j[h], rtol=1e-4)


# ---------------------------------------------------------------------------
# the binned path against the port's own sweep twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("watertight", [False, True])
def test_binned_equals_sweep_twin_bit_for_bit(terrain64, terrain96, monkeypatch, streamed,
                                              watertight):
    """On the CPU the binned path returns the sweep twin's closest hit bit
    for bit: hit, t (exact_t=False) and slot (face), and its occlusion.
    Every ray set (random, camera, per-ray t1, dead lanes, ragged N = 300)
    on terrain 64 with W at its default, the per-ray t1 and ragged sets at
    W = 1 as well (overflow: the sweep residual, or for the streamed variant
    many peel rounds), and two sets on terrain 96 (two words)."""
    sets = [(terrain64, name) for name in ("random", "camera", "per_ray_t1", "dead_lanes",
                                           "ragged")]
    for scene, name in sets + [(terrain96, "random"), (terrain96, "per_ray_t1")]:
        cs = scene[2]
        ro, rd, t1 = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                      for x in _ray_set(name, scene))
        h_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1, watertight=watertight)
        face_r = cl.slot_to_face(cs, slot_r).to(torch.int32)
        overflow = scene is terrain64 and name in ("per_ray_t1", "ragged")
        for w in (kb._W_DEFAULT, 1) if overflow else (kb._W_DEFAULT,):
            monkeypatch.setattr(kb, "W_SLOTS", w)
            tag = f"{name}, W={w}"
            h, t, face = kb.closest_hit(cs, ro, rd, T0, t1, watertight=watertight,
                                        streamed=streamed, exact_t=False)
            assert torch.equal(h, h_r) and torch.equal(t, t_r), tag
            assert torch.equal(face, face_r), tag
            occ = kb.occluded(cs, ro, rd, T0, t1, watertight=watertight, streamed=streamed)
            assert torch.equal(occ, h_r), tag
            kmin, ovf, _ = kb._trace(cs, ro, rd, T0, t1, watertight, streamed)
            keep = torch.ones_like(h) if ovf is None else ~ovf
            assert torch.equal(kb.decode(kmin)[2][keep], slot_r[keep]), tag
            if name == "dead_lanes":
                assert not h[::3].any()


def test_blocks_for_cuts_each_bin_into_pieces_of_128():
    """The streamed leaf's blockify step: one row (bin, start, count) per
    piece of at most RUN_PAIRS pairs of one bin (16; 128 when a thread
    took each pair), in order, then bin -1 rows up to the static bound
    ceil(P / RUN_PAIRS) + min(bins, P)."""
    run = kb.RUN_PAIRS
    assert run == 16
    sortd = torch.tensor([0] * (run + 2) + [2] + [5] * 3, dtype=torch.int32)
    blocks = kb.blocks_for(sortd, 8)
    assert blocks.dtype == torch.int32 and blocks.shape == (2 + 8, 3)
    assert blocks[:4].tolist() == [[0, 0, run], [0, run, 2], [2, run + 2, 1],
                                   [5, run + 3, 3]]
    assert (blocks[4:, 0] == -1).all() and (blocks[4:, 2] == 0).all()
    # a run of 128 pairs is eight full pieces
    blocks = kb.blocks_for(torch.zeros(128, dtype=torch.int32), 1)
    assert blocks.tolist() == [[0, k * run, run] for k in range(8)] + [[-1, 128, 0]]


def test_cpu_wrappers_count_twins_and_meta_raises(terrain64, monkeypatch):
    """On CPU tensors each kernel wrapper runs its twin and counts a twin
    call, never a launch; a tensor on another device (meta) raises."""
    _, _, cs, _ = terrain64
    ro, rd = (torch.from_numpy(a) for a in _random_rays(128, 3))
    monkeypatch.setattr(kb, "W_SLOTS", 1)
    kb.reset_counters()
    kb.closest_hit(cs, ro, rd, T0, T1)
    kb.occluded(cs, ro, rd, T0, T1, streamed=True)
    assert kb.prepass.twin_calls == 2 and kb.leaf.twin_calls == 1
    assert kb.leaf_streamed.twin_calls >= 2 and kb.peel.twin_calls >= 1
    assert kb.leaf_streamed.twin_calls == kb.peel.twin_calls + 1
    for fn in (kb.prepass, kb.peel, kb.leaf, kb.leaf_streamed):
        assert fn.launches == 0
    kb.reset_counters()
    assert kb.prepass.twin_calls == 0
    meta = ro.to("meta"), rd.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        kb.closest_hit(cs, *meta, T0, T1)
    with pytest.raises(ValueError, match="no kernel"):
        kb.occluded(cs, *meta, T0, T1, streamed=True)
    rays = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kb.prepass(cs, rays, T0, 6)
    with pytest.raises(ValueError, match="no kernel"):
        kb.peel(torch.zeros((4, 1), dtype=torch.int32, device="meta"), 6)
    pairs = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kb.leaf(cs, pairs, pairs.long(), rays, T0)
    with pytest.raises(ValueError, match="no kernel"):
        kb.leaf_streamed(cs, torch.zeros((1, 3), dtype=torch.int32, device="meta"),
                         pairs.long(), rays, T0)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def images(terrain64):
    """16x16, 2 spp, 3 bounces: the port's "cluster" image and the JAX
    package's "cluster_binned" image."""
    host, camera, cs, cs_j = terrain64
    camera = camera._replace(resolution=(16, 16))
    scene_t, cam_t = to_device(host, camera, "cpu")
    img = integ.render_image(scene_t, cam_t, CFG, backend="cluster", accel=cs).numpy()
    img_j = np.asarray(integ_jax.render_image(
        jax.tree.map(jnp.asarray, host), camera, CFG_JAX, backend="cluster_binned",
        accel=cs_j))
    return img, img_j


@pytest.mark.parametrize("backend", ["cluster_binned", "cluster_streamed"])
def test_render_image_binned_matches_cluster_and_jax(terrain64, images, backend):
    """render_image with a binned backend equals the port's "cluster" image
    exactly, and is close to the JAX package's "cluster_binned" image on
    > 99% of pixels (rtol 1e-4, atol 1e-6)."""
    host, camera, cs, _ = terrain64
    scene_t, cam_t = to_device(host, camera._replace(resolution=(16, 16)), "cpu")
    kb.reset_counters()
    img = integ.render_image(scene_t, cam_t, CFG, backend=backend, accel=cs).numpy()
    assert kb.prepass.twin_calls == 2 * 2 * 3
    kb.reset_counters()
    img_cluster, img_j = images
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0.05
    np.testing.assert_array_equal(img, img_cluster)
    assert np.isclose(img, img_j, rtol=1e-4, atol=1e-6).mean() > 0.99


@pytest.mark.cuda
def test_binned_kernels_match_twins_on_gpu(terrain96):
    """On a CUDA device: each binned kernel against its twin (bit for bit),
    the prepass and the peel also on their launch edges
    (clusterbench.prepass_edges: dead rays of every kind, t1 exactly t0,
    ragged N) and the peel on the edge words of the CPU test (bit 31, full
    words), the leaves on theirs (clusterbench.edge_streams) and the
    duplicate triangles (clusterbench.duplicate_set), and both variants
    against the sweep twin (run on the card with
    `python -m pytest tests/test_torch_binned.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cs = terrain96[2].to(dev)
    ro, rd = (torch.from_numpy(a).to(dev) for a in _random_rays(1 << 12, 0))
    t1 = torch.where(torch.arange(1 << 12, device=dev) % 3 == 0, 0.0, 0.7)
    rays = kc._prepare(cs, ro, rd, t1, sort=False)[0]
    cs_d, rays_d, sortd_d, pair_d, copies, _ = cb.duplicate_set(cs, dev)
    streams = cb.edge_streams(kb, cs, kc._prepare(cs, ro, rd, T1, sort=False)[0])
    for label, (scene, (sortd, pair_ray, r)) in [
            ("duplicate triangles", (cs_d, (sortd_d, pair_d, rays_d)))] + [
            (label, (cs, stream)) for label, stream in streams.items()]:
        blocks = kb.blocks_for(sortd, cs.n_clusters // cl.BIN)
        for wt in (False, True):
            keys = kb.leaf(scene, sortd, pair_ray, r, T0, wt)
            assert torch.equal(keys, kb.leaf_ref(scene, sortd, pair_ray, r, T0, wt)), label
            assert torch.equal(kb.leaf_streamed(scene, blocks, pair_ray, r, T0, wt),
                               kb.leaf_streamed_ref(scene, blocks, pair_ray, r, T0, wt)), label
            if scene is cs_d:
                assert not torch.isin(kb.decode(keys)[2], torch.tensor(copies, device=dev)).any()
    for label, r in cb.prepass_edges(cs, rays).items():
        for w in (6, 1):
            for emit in (False, True):
                for a, b in zip(kb.prepass(cs, r, T0, w, emit), kb.prepass_ref(cs, r, T0, w, emit)):
                    assert torch.equal(a, b), (label, w, emit)
    edge_words = torch.from_numpy(cb.edge_words(1024, 2)).to(dev)
    for w in (1, 6, 10):
        words = edge_words
        while bool((words != 0).any()):
            out = kb.peel(words, w)
            for a, b in zip(out, kb.peel_ref(words, w)):
                assert torch.equal(a, b), w
            words = out[2]
    for w in (6, 1):
        ids, ovf, words = kb.prepass(cs, rays, T0, w, emit_words=True)
        for a, b in zip((ids, ovf, words), kb.prepass_ref(cs, rays, T0, w, emit_words=True)):
            assert torch.equal(a, b)
        for a, b in zip(kb.peel(words, w), kb.peel_ref(words, w)):
            assert torch.equal(a, b)
        sortd, pair_ray = kb.sort_pairs(ids, int((ids != kb.SENTINEL).sum()))
        blocks = kb.blocks_for(sortd, cs.n_clusters // cl.BIN)
        for wt in (False, True):
            keys = kb.leaf(cs, sortd, pair_ray, rays, T0, wt)
            assert torch.equal(keys, kb.leaf_ref(cs, sortd, pair_ray, rays, T0, wt))
            assert torch.equal(kb.leaf_streamed(cs, blocks, pair_ray, rays, T0, wt), keys)
    for wt in (False, True):
        h_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1, watertight=wt)
        for streamed in (False, True):
            h, t, face = kb.closest_hit(cs, ro, rd, T0, t1, watertight=wt, streamed=streamed,
                                        exact_t=False)
            assert torch.equal(h, h_r) and torch.equal(t, t_r)
            assert torch.equal(face, cl.slot_to_face(cs, slot_r).to(torch.int32))
            assert torch.equal(kb.occluded(cs, ro, rd, T0, t1, watertight=wt,
                                           streamed=streamed), h_r)
