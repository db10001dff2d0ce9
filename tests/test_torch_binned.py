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
from pyrenderer_tpu_torch.render import cli
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene

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
    AUTO_BRUTE_MAX_TRIS, into "cluster_binned" on both devices, as the JAX
    package does (core/integrator.py:178-179, :204); the binned backends
    resolve to themselves, and "auto" never picks "cluster_streamed"."""
    limit = integ.AUTO_BRUTE_MAX_TRIS
    monkeypatch.setenv("PYRENDERER_CLUSTER_IMPL", "binned")
    for dev in ("cpu", "cuda:0"):
        assert integ.resolve_backend("cluster", 36, dev) == "cluster_binned"
        assert integ.resolve_backend("auto", limit + 1, dev) == "cluster_binned"
        assert integ.resolve_backend("auto", limit, dev) in ("brute", "cuda")
        for b in ("cluster_binned", "cluster_streamed"):
            assert integ.resolve_backend(b, 36, dev) == b
    host, camera, _, _ = terrain64
    scene, _ = to_device(host, camera, "cpu")
    accel = integ.maybe_build_accel(scene, "auto")
    assert isinstance(accel, cl.ClusterScene) and accel.bin_box.shape == (32, 128)
    tables = integ.TraceTables(scene, CFG, "cluster", accel=accel)
    assert tables.backend == "cluster_binned" and not tables.cluster_sort
    monkeypatch.delenv("PYRENDERER_CLUSTER_IMPL")
    for n_tris in (36, limit + 1, 10 ** 6):
        for dev in ("cpu", "cuda:0"):
            assert integ.resolve_backend("auto", n_tris, dev) != "cluster_streamed"
    assert integ.resolve_backend("auto", limit + 1, "cpu") == "cluster"
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
    piece of at most 128 pairs of one bin, in order, then bin -1 rows up to
    the static bound ceil(P / 128) + min(bins, P)."""
    sortd = torch.tensor([0] * 130 + [2] + [5] * 3, dtype=torch.int32)
    blocks = kb.blocks_for(sortd, 8)
    assert blocks.dtype == torch.int32 and blocks.shape == (2 + 8, 3)
    assert blocks[:4].tolist() == [[0, 0, 128], [0, 128, 2], [2, 130, 1], [5, 131, 3]]
    assert (blocks[4:, 0] == -1).all() and (blocks[4:, 2] == 0).all()


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
    and both variants against the sweep twin (run on the card with
    `python -m pytest tests/test_torch_binned.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cs = terrain96[2].to(dev)
    ro, rd = (torch.from_numpy(a).to(dev) for a in _random_rays(1 << 12, 0))
    t1 = torch.where(torch.arange(1 << 12, device=dev) % 3 == 0, 0.0, 0.7)
    rays = kc._prepare(cs, ro, rd, t1, sort=False)[0]
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
