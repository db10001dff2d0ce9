"""perf/microbench.py's and perf/ablate.py's stages in
pyrenderer_tpu_torch.perf.microbench / .ablate against their JAX
counterparts on the CPU: the same inputs (the JAX harnesses' draws from
RandomState(0), 1,024 rays) through each stage of the port and through the
JAX package's public functions."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu import rng as prng
from pyrenderer_tpu.config import RenderConfig as JaxConfig
from pyrenderer_tpu.core import integrator as integ_jax
from pyrenderer_tpu.core import intersect as isect_jax
from pyrenderer_tpu.core import lut, sampling
from pyrenderer_tpu.core.camera import generate_rays as generate_rays_jax
from pyrenderer_tpu.kernels import pallas_intersect as pk
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu_torch.perf import ablate, estbench, microbench

torch.set_num_threads(2)

N = 1024


@pytest.fixture(scope="module")
def setup():
    x = microbench.inputs("cpu", N, backend="brute")
    host, camera, _ = load_tungsten(estbench.SCENE, dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, host)
    h = x.host
    j = dict(scene=scene, camera=camera, ro=jnp.asarray(h["ro"]), rd=jnp.asarray(h["rd"]),
             px=jnp.asarray(h["px"]), py=jnp.asarray(h["py"]),
             pid=jnp.arange(N, dtype=jnp.uint32), tm=isect_jax.build_tri_matrix(scene))
    return x, j


def _mismatched_rays(a, b):
    return int((~np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=1)).sum())


def test_inputs_are_the_jax_harness_draws(setup):
    x, _ = setup
    rs = np.random.RandomState(0)
    ro = rs.uniform(-0.9, 0.9, (N, 3)).astype(np.float32) + np.float32([0, 1, 0])
    assert np.array_equal(x.ro.numpy(), ro)
    assert float(np.abs(np.linalg.norm(x.host["rd"], axis=1) - 1).max()) < 1e-6


@pytest.mark.parametrize("stage", ["cuda_closest", "cuda_occluded"])
def test_whole_table_rows_match_pallas_interpret(setup, stage):
    """B1 / B2 (their twins here) against the TPU kernels in interpret mode,
    with tests/test_torch_intersect.py's bounds: hit masks and occlusion
    equal, faces equal on >= 0.995 of the hits, t at rtol 1e-5 against the
    float32 NumPy oracle and against interpret mode, except where XLA:CPU's
    FMAs move interpret mode's t further (ROADMAP C3): there the twin equals
    the oracle bit for bit."""
    x, j = setup
    table = pk.pack_triangles(j["scene"].vertices, j["scene"].faces)
    if stage == "cuda_occluded":
        got = microbench.cuda_occluded(x.tri_table, x.ro, x.rd, x.t2).numpy()
        want = np.asarray(pk.occluded(table, j["ro"], j["rd"], 1e-5, jnp.full((N,), 2.0),
                                      interpret=True))
        assert got.any() and np.array_equal(got, want)
        return
    h, t, tri = (a.numpy() for a in microbench.cuda_closest(x.tri_table, x.ro, x.rd))
    h_j, t_j, tri_j = (np.asarray(a) for a in pk.closest_hit(table, j["ro"], j["rd"], 1e-5,
                                                              1e5, interpret=True))
    assert h.any() and np.array_equal(h, h_j)
    same = h & (tri == tri_j)
    assert same[h].mean() >= 0.995
    host = x.host
    scene_np = type(j["scene"])(*[np.asarray(a) for a in j["scene"]])
    t_np = np.array([ref.intersect_ray(scene_np, host["ro"][i], host["rd"][i], 1e-5, 1e5)[1]
                     for i in range(N)], np.float32)
    np.testing.assert_allclose(t[h], t_np[h], rtol=1e-5)
    fused = same & ~np.isclose(t, t_j, rtol=1e-5, atol=0.0)
    assert np.array_equal(t[fused], t_np[fused])


def test_packed_gather16_and_vertex_gather_bit_for_bit(setup):
    x, j = setup
    fd = integ_jax.pack_face_data(j["scene"])
    tri = jnp.arange(N, dtype=jnp.int32) % j["scene"].faces.shape[0]
    assert np.array_equal(microbench.packed_gather16(x.face_data, x.tri).numpy(),
                          np.asarray(fd[tri]))
    f = j["scene"].faces[tri]
    v = j["scene"].vertices
    assert np.array_equal(microbench.vertex_gather(x.scene, x.tri).numpy(),
                          np.asarray(v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]))


@pytest.mark.parametrize("stage", ["intersect_matmul", "intersect_brute"])
def test_closest_queries_match_jax(setup, stage):
    """The plain closest-hit queries against JAX's (matmul at HIGHEST): hit
    masks and faces equal on > 99.5% of the rays, t within rtol 2e-4 where
    the faces agree (tests/test_torch_matmul.py's bounds)."""
    x, j = setup
    if stage == "intersect_matmul":
        got = microbench.intersect_matmul(x.scene, x.tri_matrix, x.ro, x.rd)
        want = isect_jax.intersect_matmul(j["scene"], j["ro"], j["rd"], 1e-5, 1e5, j["tm"])
    else:
        got = microbench.intersect_brute(x.scene, x.ro, x.rd)
        want = isect_jax.intersect_brute(j["scene"], j["ro"], j["rd"], 1e-5, 1e5)
    h, t, tri = (a.numpy() for a in got)
    h_j, t_j, tri_j = (np.asarray(a) for a in want)
    assert h.any() and (h == h_j).mean() > 0.995 and (tri == tri_j).mean() > 0.995
    same = h & h_j & (tri == tri_j)
    np.testing.assert_allclose(t[same], t_j[same], rtol=2e-4, atol=2e-5)


def test_occluded_matmul_matches_jax(setup):
    x, j = setup
    got = microbench.occluded_matmul(x.scene, x.tri_matrix, x.ro, x.rd, x.t2).numpy()
    want = np.asarray(isect_jax.occluded_matmul(j["scene"], j["ro"], j["rd"], 1e-5,
                                                jnp.full((N,), 2.0), j["tm"]))
    assert got.any() and (got == want).mean() > 0.995


def test_rng_8draws_bit_for_bit(setup):
    """The eight uniforms' sum, in the JAX harness's order of adds."""
    x, j = setup
    want = sum(prng.uniform(0, j["pid"], 0, 1, u) for u in range(8))
    got = microbench.rng_8draws(x.pid).numpy()
    assert np.array_equal(got.view(np.int32), np.asarray(want).view(np.int32))


def test_frame_math_matches_jax(setup):
    """rtol 1e-4, atol 1e-6 (the integrator tests' tolerance); its uniforms
    bit for bit."""
    x, j = setup
    u1, u2 = microbench.frame_uniforms(x.pid)
    u1_j, u2_j = prng.uniform(0, j["pid"], 0, 0, 0), prng.uniform(0, j["pid"], 0, 0, 1)
    assert np.array_equal(u1.numpy(), np.asarray(u1_j))
    assert np.array_equal(u2.numpy(), np.asarray(u2_j))
    got = microbench.frame_math(x.rd, u1, u2).numpy()
    want = sampling.rotate_z_to(-j["rd"], sampling.cosine_sample_hemisphere(u1_j, u2_j))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-6)


def test_trace_4bounce_counts_the_jax_rays(setup):
    """The with_stats ray count equal to JAX's, the radiance by ROADMAP C4's
    first criterion (at most 2% of the rays differ)."""
    x, j = setup
    rad, n_rays = microbench.trace_4bounce(x.scene, x.cfg, x.tables, x.ro, x.rd, x.pid)
    cfg = JaxConfig(max_bounces=4, spp=1, seed=0)
    rad_j, n_j = integ_jax.trace_reference(
        j["scene"], cfg, j["ro"], j["rd"], j["pid"], j["pid"] * 0, 0,
        tables=integ_jax.TraceTables(j["scene"], cfg, "brute"), with_stats=True)
    assert float(n_rays) == float(n_j) > N
    assert _mismatched_rays(rad.numpy(), np.asarray(rad_j)) <= 0.02 * N


def test_camera_raygen_matches_jax(setup):
    x, j = setup
    ro, rd = microbench.camera_raygen(x.camera, x.px, x.py)
    ro_j, rd_j = generate_rays_jax(j["camera"], j["px"], j["py"],
                                   j["px"].astype(jnp.uint32) * 0, 0)
    np.testing.assert_allclose(ro.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), atol=1e-6)


MB_ROWS = ["cuda_closest", "cuda_occluded", "packed_gather16", "intersect_matmul",
           "intersect_brute", "occluded_matmul", "rng_8draws", "frame_math", "vertex_gather",
           "trace_4bounce_brute", "camera_raygen"]


def test_microbench_main_on_the_cpu(capsys, monkeypatch):
    """Every row and one JSON line; MB_N sets the ray count, MB_ONLY keeps the
    rows whose names (or the JAX names, pallas_*) start with its prefixes;
    the trace row carries a RenderStats summary."""
    monkeypatch.setenv("MB_N", "256")
    assert microbench.main(["--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    for name in MB_ROWS:
        assert any(line.startswith(name + " ") for line in out), name
    result = json.loads(out[-1])
    assert result["n"] == 256 and [r["name"] for r in result["rows"]] == MB_ROWS
    trace = result["rows"][MB_ROWS.index("trace_4bounce_brute")]
    assert trace["twin_calls"] == {} and "Mrays/s" in (trace.get("summary") or "Mrays/s")
    monkeypatch.setenv("MB_ONLY", "pallas,rng")
    assert microbench.main(["--device", "cpu", "--reps", "1", "--n", "128"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["name"] for r in result["rows"]] == ["cuda_closest", "cuda_occluded",
                                                   "rng_8draws"]
    assert result["rows"][0]["twin_calls"] == {"closest_hit": 1}


# --------------------------------------------------------------------------
# ablate
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ablation(setup):
    x = ablate.inputs("cpu", N)
    _, j = setup
    cfg = JaxConfig(max_bounces=4, seed=0)
    j = dict(j, cfg=cfg, tables=integ_jax.TraceTables(j["scene"], cfg, "auto"))
    return x, j


def test_ablate_full_4bounce_matches_jax(ablation):
    x, j = ablation
    got = ablate.full_4bounce(x.scene, x.cfg, x.tables, x.ro, x.rd, x.pid).numpy()
    want = integ_jax.trace_reference(j["scene"], j["cfg"], j["ro"], j["rd"], j["pid"],
                                     j["pid"] * 0, 0, tables=j["tables"])
    assert float(np.abs(got).max()) > 0.05
    assert _mismatched_rays(got, np.asarray(want)) <= 0.02 * N


def test_ablate_isect_only_matches_jax(ablation):
    """The JAX harness's isect_only scan as a loop of the JAX integrator's
    _closest and _any_hit: at most 2% of the rays end elsewhere (C4's
    first criterion; a ray whose query flips moves on another way)."""
    x, j = ablation
    got = ablate.isect_only(x.scene, x.cfg, x.tables, x.ro, x.rd).numpy()
    ro, rd = j["ro"], j["rd"]
    for _ in range(4):
        _, t, _ = integ_jax._closest(j["scene"], j["tables"], j["cfg"], ro, rd, j["cfg"].t_max)
        occ = integ_jax._any_hit(j["scene"], j["tables"], j["cfg"], ro, rd, t)
        ro = ro + t[:, None] * rd * 0.5
        rd = jnp.where(occ[:, None], -rd, rd)
    assert _mismatched_rays(got, np.asarray(ro)) <= 0.02 * N


def test_ablate_fetch_only_matches_jax(ablation):
    x, j = ablation
    got = ablate.fetch_only(x.scene, x.tables, x.ro, x.pid).numpy()
    pid = j["pid"]
    acc = j["ro"] * 0
    for b in range(4):
        tri = (pid + b).astype(jnp.int32) % j["scene"].faces.shape[0]
        row = lut.fetch_rows(j["tables"].face_data, tri)
        p2, n2, em, _ = integ_jax._sample_light_point(j["scene"], j["tables"], pid, pid * 0,
                                                      jnp.uint32(b), 0, jnp.float32)
        acc = acc + row[:, 0:3] + p2 * n2 * em
    np.testing.assert_allclose(got, np.asarray(acc), rtol=1e-4, atol=1e-6)


def test_ablate_rng_frame_matches_jax(ablation):
    x, j = ablation
    got = ablate.rng_frame(x.ro, x.rd, x.pid).numpy()
    ro, rd, pid = j["ro"], j["rd"], j["pid"]
    for b in range(4):
        u1, u2 = prng.uniform2(0, pid, pid * 0, jnp.uint32(b), prng.U_BSDF_0, jnp.float32)
        wi = sampling.rotate_z_to(-rd, sampling.cosine_sample_hemisphere(u1, u2))
        ro, rd = ro + wi * 0.01, wi
    np.testing.assert_allclose(got, np.asarray(ro), rtol=1e-4, atol=1e-6)


def test_ablate_main_on_the_cpu(capsys):
    assert ablate.main(["--device", "cpu", "--n", "256", "--reps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    names = ["full_4bounce", "isect_only_4x2", "fetch_only_4x", "rng_frame_4x"]
    for name in names:
        assert any(line.startswith(name + " ") for line in out), name
    result = json.loads(out[-1])
    assert [r["name"] for r in result["rows"]] == names and result["backend"] == "brute"
    assert all(r["launches"] == {} and r["twin_calls"] == {} for r in result["rows"])
