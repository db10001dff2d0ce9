"""pyrenderer_tpu_torch suspend/resume rounds: the resume mode of the
cluster closest-hit kernel (csrc/cluster.cu, Resume = true), its twin
accel/clusters.closest_hit_resume_ref, and the rounds loop of
kernels/cluster.closest_hit, at terrain8k, against the one-pass result and
the JAX package's interpret-mode rounds sweep."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.accel import clusters as clj
from pyrenderer_tpu.kernels import pallas_cluster as pc
from pyrenderer_tpu_torch import kernels
from pyrenderer_tpu_torch.accel import clusters as cl
from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core import integrator as integ
from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels import cluster as kc
from pyrenderer_tpu_torch.scene import procgen, to_device
from pyrenderer_tpu_torch.scene.tungsten import build_scene
from tests.torch_fixtures import private_jax_native_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

T0, T1 = 1e-5, 1e5
BUDGETS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def terrain():
    host, camera, _ = build_scene(procgen.big_scene_data("terrain", res=64))
    return host, camera, cl.build_clusters(host.vertices, host.faces)


def _random_rays(n, seed):
    """Rays inside the box, as tests/test_cluster.py makes them."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _rays_t(n=512, seed=13):
    return tuple(torch.from_numpy(a) for a in _random_rays(n, seed))


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("watertight", [False, True])
def test_rounds_equal_one_pass(terrain, watertight, sort):
    """closest_hit with rounds=2 at budgets 1-8 gives the one-pass t and face
    bit for bit on 512 random rays (a third of them with t1 = 0.5), and at
    budget 1 some rays are suspended."""
    _, _, cs = terrain
    ro, rd = _rays_t()
    t1 = torch.where(torch.arange(512) % 3 == 0, 0.5, T1)
    h0, t_0, f0 = kc.closest_hit(cs, ro, rd, T0, t1, watertight=watertight, exact_t=False)
    assert h0.any()
    for budget in BUDGETS:
        ops = kc._operands(cs, ro, rd, t1, sort)
        done = kc.suspend_pass(cs, ops, T0, budget, watertight)[2]
        if budget == 1:
            assert (done == 0).any()
        h, t, f = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort, watertight=watertight,
                                 exact_t=False, rounds=2, budget=budget)
        assert torch.equal(h, h0) and torch.equal(t, t_0) and torch.equal(f, f0), budget
    kc.reset_counters()


@pytest.mark.parametrize("budget, watertight", [(1, False), (2, True), (4, False), (8, True)])
def test_rounds_match_pallas_interpret(terrain, budget, watertight):
    """rounds=2 against the JAX package's interpret-mode rounds sweep (whose
    budget counts per 128-ray tile), by the criterion of
    tests/test_cluster.py:131-149: equal hit masks, faces on >= 99.5% of
    hits, t at rtol 1e-4."""
    host, _, cs = terrain
    cs_j = clj.build_clusters(np.asarray(host.vertices), np.asarray(host.faces))
    ro, rd = _random_rays(512, 13)
    h, t, f = (x.numpy() for x in kc.closest_hit(
        cs, torch.from_numpy(ro), torch.from_numpy(rd), T0, T1, sort=True,
        watertight=watertight, rounds=2, budget=budget))
    h_j, t_j, f_j = (np.asarray(x) for x in pc.closest_hit(
        cs_j, jnp.asarray(ro), jnp.asarray(rd), T0, T1, sort=True, watertight=watertight,
        interpret=True, rounds=2, budget=budget))
    assert h.any() and np.array_equal(h, h_j)
    assert (f[h] == f_j[h]).mean() >= 0.995
    np.testing.assert_allclose(t[h], t_j[h], rtol=1e-4)
    kc.reset_counters()


def test_resume_twin_contract(terrain):
    """One pass of the resume twin: budget 0 resolves every ray (done 1) and
    equals the one-pass twin; a budgeted pass suspends rays only where a
    rank is left, and a resume from its carried state finishes them; a dead
    ray keeps its carried (t, slot); the keys pack and unpack."""
    _, _, cs = terrain
    ro, rd = _rays_t(256, 5)
    t1 = torch.where(torch.arange(256) % 4 == 0, 0.0, T1)
    rays, _, order, sup = kc._operands(cs, ro, rd, t1, False)
    miss_t = torch.full((256,), cl.MISS_T)
    miss_s = torch.full((256,), -1, dtype=torch.int32)
    t, slot, done = cl.closest_hit_resume_ref(cs, rays, order, sup, miss_t, miss_s, T0, 0)
    h_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1)
    assert bool(done.all()) and torch.equal(slot, slot_r)
    assert torch.equal(torch.where(h_r, t, 0.0), t_r) and bool((t[~h_r] == cl.MISS_T).all())
    t_b, slot_b, done_b = cl.closest_hit_resume_ref(cs, rays, order, sup, miss_t, miss_s, T0, 1)
    assert (done_b == 0).any() and bool(done_b[t1 == 0].all())
    t_f, slot_f, done_f = cl.closest_hit_resume_ref(cs, rays, order, sup, t_b, slot_b, T0, 0)
    assert bool(done_f.all()) and torch.equal(slot_f, slot) and torch.equal(t_f, t)
    # dead rays keep what they carry
    carried_t = torch.linspace(1.0, 2.0, 256)
    carried_s = torch.arange(256, dtype=torch.int32)
    dead = rays.clone()
    dead[:, 6] = 0.0
    t_d, slot_d, done_d = cl.closest_hit_resume_ref(cs, dead, order, sup, carried_t, carried_s,
                                                    T0, 3)
    assert torch.equal(t_d, carried_t) and torch.equal(slot_d, carried_s) and bool(done_d.all())
    keys = cl.pack_key(torch.tensor([0.5, 0.5, 2.0, cl.MISS_T]),
                       torch.tensor([7, 3, 0, -1], dtype=torch.int32))
    assert keys.argmin() == 1 and keys[3] == keys.max()
    t_u, s_u = cl.unpack_key(keys)
    assert t_u.tolist() == [0.5, 0.5, 2.0, np.float32(cl.MISS_T)]
    assert s_u.tolist() == [7, 3, 0, -1]


def _resume_stand_in(cs, names):
    """A stand-in for build.launch on the resume route: checks the operands
    and writes the resume twin's (t, slot, done) through the outputs."""
    def launch(name, device, tri, child_box, super_sorted, order, s_pad, rays, t0, n,
               watertight, t_in, slot_in, budget, t_out, slot_out, done_out):
        assert name == "pr_cluster_closest_resume"
        assert (tri, child_box) == (cs.tri.data_ptr(), cs.child_box8.data_ptr())
        as_t = {}
        for ptr, count, dtype in ((rays, n * 8, torch.float32), (t_in, n, torch.float32),
                                  (slot_in, n, torch.int32), (order, s_pad, torch.int32),
                                  (super_sorted, s_pad * cl.BOX_ROW, torch.float32)):
            buf = torch.empty(count, dtype=dtype)
            ctypes.memmove(buf.data_ptr(), ptr, count * buf.element_size())
            as_t[ptr] = buf
        results = cl.closest_hit_resume_ref(
            cs, as_t[rays].reshape(n, 8), as_t[order], as_t[super_sorted].reshape(s_pad, 8),
            as_t[t_in], as_t[slot_in], t0, budget, bool(watertight))
        for ptr, x in zip((t_out, slot_out, done_out), results):
            ctypes.memmove(ptr, x.contiguous().data_ptr(), x.numel() * x.element_size())
        names.append((name, budget))
    return launch


@pytest.mark.parametrize("sort", [False, True])
def test_rounds_route_launches_twice_per_query(terrain, monkeypatch, sort):
    """The CUDA route of rounds=2 with a stand-in for the kernel launch: one
    budgeted launch and one unbudgeted one, each counted in
    closest_hit.launches and in its pass's wrapper, no twin call, and the
    one-pass twin's result in the caller's order."""
    _, _, cs = terrain
    ro, rd = _rays_t(300, 7)
    t1 = torch.where(torch.arange(300) % 3 == 0, 0.0, T1)
    names = []
    monkeypatch.setattr(build, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(build, "launch", _resume_stand_in(cs, names))
    kernels.reset_counters()
    h, t, f = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort, exact_t=False, rounds=2, budget=2)
    launches, twins = kernels.counts()
    kernels.reset_counters()
    assert names == [("pr_cluster_closest_resume", 2), ("pr_cluster_closest_resume", 0)]
    assert launches == {"cluster_closest_hit": 2, "cluster_closest_suspend": 1,
                        "cluster_closest_resume": 1} and twins == {}
    monkeypatch.undo()
    h_r, t_r, slot_r = cl.closest_hit_ref(cs, ro, rd, T0, t1)
    assert h_r.any() and torch.equal(h, h_r) and torch.equal(t, t_r)
    assert torch.equal(f, cl.slot_to_face(cs, slot_r).to(torch.int32))


def test_render_rounds_equal_one_pass(terrain):
    """render_image through backend "cluster" with cluster_rounds=2 (budget
    1, MT, and budget 8, watertight) equals the rounds=1 image bit for bit;
    each closest-hit query runs two twin passes on the CPU, beside the
    Threefry twin's 2 + 3 a bounce draws."""
    host, camera, cs = terrain
    scene, cam = to_device(host, camera._replace(resolution=(12, 12)), "cpu")
    for budget, wt in ((1, False), (8, True)):
        cfg = RenderConfig(max_bounces=3, spp=1, seed=3, estimator="reference",
                           cluster_watertight=wt)
        img = integ.render_image(scene, cam, cfg, backend="cluster", accel=cs)
        kernels.reset_counters()
        img2 = integ.render_image(scene, cam, cfg.replace(cluster_rounds=2, cluster_budget=budget),
                                  backend="cluster", accel=cs)
        _, twins = kernels.counts()
        kernels.reset_counters()
        assert img.max() > 0 and torch.equal(img, img2)
        assert twins == {"cluster_closest_hit": 6, "cluster_closest_suspend": 3,
                         "cluster_closest_resume": 3, "cluster_occluded": 3, "threefry": 11}


@pytest.mark.cuda
def test_resume_kernel_matches_twin_on_gpu(terrain):
    """On a CUDA device: the resume mode against its twin at terrain8k, MT
    and watertight, sort off and on, budgets 1, 2 and 8: round 1's t, slot
    and done bit for bit, some rays suspended at budget 1, and after
    rounds=2 the one-pass kernel's t and face on every ray (run on the card
    with `python -m pytest tests/test_torch_resume.py -m cuda`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cs = terrain[2].to(dev)
    ro, rd = (x.to(dev) for x in _rays_t(1 << 14, 0))
    t1 = torch.where(torch.arange(1 << 14, device=dev) % 3 == 0, 0.0, 0.5)
    for wt in (False, True):
        h0, t_0, f0 = kc.closest_hit(cs, ro, rd, T0, t1, watertight=wt, exact_t=False)
        for sort in (False, True):
            ops = kc._operands(cs, ro, rd, t1, sort)
            for budget in (1, 2, 8):
                t, slot, done = kc.suspend_pass(cs, ops, T0, budget, wt)
                n = ro.shape[0]
                t_r, slot_r, done_r = cl.closest_hit_resume_ref(
                    cs, ops[0], ops[2], ops[3], torch.full((n,), cl.MISS_T, device=dev),
                    torch.full((n,), -1, dtype=torch.int32, device=dev), T0, budget, wt)
                assert torch.equal(t, t_r) and torch.equal(slot, slot_r), (wt, sort, budget)
                assert torch.equal(done, done_r), (wt, sort, budget)
                if budget == 1:
                    assert (done == 0).any()
                h, tt, f = kc.closest_hit(cs, ro, rd, T0, t1, sort=sort, watertight=wt,
                                          exact_t=False, rounds=2, budget=budget)
                assert torch.equal(h, h0) and torch.equal(tt, t_0) and torch.equal(f, f0)
    kc.reset_counters()
