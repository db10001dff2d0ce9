"""perf/binnedglue.py's stages in pyrenderer_tpu_torch.perf.binnedglue, and
perf/binnedgran.py's children, against their JAX counterparts on the CPU:
the JAX harness's rays (numpy.random.default_rng(0), 1,024 of them) above
terrain res 64 through each stage of the port's binned pipeline and
through the JAX package's functions (the TPU kernels in interpret mode)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu.accel import clusters as clj
from pyrenderer_tpu.kernels import pallas_binned as pb
from pyrenderer_tpu.kernels import pallas_cluster as pc
from pyrenderer_tpu.scene.procgen import terrain
from pyrenderer_tpu_torch.kernels import binned as kb
from pyrenderer_tpu_torch.perf import binnedglue, binnedgran
from tests.torch_fixtures import private_jax_native_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

N = 1024
RES = 64
T0, T1 = binnedglue.T0, binnedglue.T1


@pytest.fixture(scope="module")
def setup():
    x = binnedglue.inputs("cpu", N, RES)
    cs_j = clj.build_clusters(*terrain(RES))
    ro, rd = x.host["ro"], x.host["rd"]
    ro_p, rd_p, t1v, _ = pb._pad_rays(jnp.asarray(ro), jnp.asarray(rd), T1)
    lane, cols = pc._pack_rays(ro_p, rd_p, t1v)
    return x, dict(cs=cs_j, ro=jnp.asarray(ro), rd=jnp.asarray(rd), lane=lane, cols=cols)


def _words_ray_major(words, n_words):
    """JAX's lane-layout words (tiles * n_words, 128) -> (N_pad, n_words)."""
    w = np.asarray(words)
    tiles = w.shape[0] // n_words
    return w.reshape(tiles, n_words, 128).transpose(0, 2, 1).reshape(tiles * 128, n_words)


def test_inputs(setup):
    """The JAX harness's rays; the clusters are JAX's; pack_rays is the JAX
    column form; the chain of stages found pairs to time."""
    x, j = setup
    rng = np.random.default_rng(0)
    ro = (rng.uniform(-0.8, 0.8, (N, 3)) + np.array([0, 1.5, 0])).astype(np.float32)
    assert np.array_equal(x.ro.numpy(), ro)
    assert np.array_equal(x.cs.order.numpy(), np.asarray(j["cs"].order))
    assert np.array_equal(binnedglue.pack_rays(x.cs, x.ro, x.rd, x.t1v).numpy(),
                          np.asarray(j["cols"])[:N])
    assert x.n_real > 20 and x.n_bins == x.cs.n_clusters // 4


def test_prepass_and_peel_bit_for_bit(setup):
    """B5's twin at W = 6 and B6's at W = 10 (on the streamed prepass's
    words) against pb._prepass_call / pb._peel_call in interpret mode."""
    x, j = setup
    ids, ovf = binnedglue.prepass(x.cs, x.rays, x.w)
    ids_j, ovf_j = pb._prepass_call(j["cs"], j["lane"], T0, x.w, True)
    assert np.array_equal(ids.numpy(), np.asarray(ids_j)[:N])
    assert np.array_equal(ovf.numpy(), np.asarray(ovf_j)[:N])
    n_words = x.words.shape[1]
    _, _, words_j = pb._prepass_call(j["cs"], j["lane"], T0, x.w_streamed, True,
                                     emit_words=True)
    assert np.array_equal(x.words.numpy(), _words_ray_major(words_j, n_words)[:N])
    ids2, ovf2, left = binnedglue.peel(x.words, x.w_streamed)
    ids2_j, ovf2_j, left_j = pb._peel_call(j["cs"], words_j, x.w_streamed, True)
    assert np.array_equal(ids2.numpy(), np.asarray(ids2_j)[:N])
    assert np.array_equal(ovf2.numpy(), np.asarray(ovf2_j)[:N])
    assert np.array_equal(left.numpy(), _words_ray_major(left_j, n_words)[:N])


def test_sort_pairs_bit_for_bit(setup):
    """The port's one sort against the JAX harness's sort2 (jax.lax.sort of
    the flat candidate slots with their positions, one key): the same bins
    and rays, cut to the real pairs."""
    x, _ = setup
    sortd, pair_ray = binnedglue.sort_pairs(x.ids, x.n_real)
    flat = jnp.asarray(x.ids.numpy().reshape(-1))
    s_j, q_j = jax.lax.sort([flat, jnp.arange(flat.shape[0], dtype=jnp.int32)], num_keys=1)
    assert np.array_equal(sortd.numpy(), np.asarray(s_j)[:x.n_real])
    assert np.array_equal(pair_ray.numpy(), np.asarray(q_j)[:x.n_real] // x.w)
    assert int((np.asarray(s_j) != pb.SENTINEL).sum()) == x.n_real


def test_leaves_match_pallas_interpret(setup):
    """B7's twin on the sorted pairs against pb._leaf_call in interpret mode
    (tests/test_torch_binned.py's decoding and bounds: equal hit masks,
    slots on > 0.995 of the hits, t within 2^-13 relative); B8's twin on
    the same pairs, cut by blocks_for, gives B7's keys bit for bit."""
    x, j = setup
    keys = binnedglue.leaf(x.cs, x.sortd, x.pair_ray, x.rays)
    hit, t, slot = kb.decode(keys)
    n = x.n_real
    p_pad = -(-n // (pb.BPS * 128)) * (pb.BPS * 128)
    sortd_j = np.full(p_pad, pb.SENTINEL, np.int32)
    sortd_j[:n] = x.sortd.numpy()
    prcol = np.zeros((p_pad, 8), np.float32)
    prcol[:n] = x.rays[x.pair_ray].numpy()
    keys_j = np.asarray(pb._leaf_call(j["cs"], jnp.asarray(sortd_j), jnp.asarray(prcol), T0,
                                      False, True))[:n]
    hit_j = keys_j < pb.MISS_KEY
    assert hit.any() and np.array_equal(hit.numpy(), hit_j)
    h = hit.numpy()
    slot_j = sortd_j[:n] * pb.BIN_TRIS + (keys_j & 511)
    assert (slot.numpy()[h] == slot_j[h]).mean() > 0.995
    np.testing.assert_allclose(t.numpy()[h], (keys_j & ~np.int32(511)).view(np.float32)[h],
                               rtol=2.0 ** -13)
    blocks = binnedglue.blocks_for(x.sortd, x.n_bins)
    assert np.array_equal(binnedglue.leaf_streamed(x.cs, blocks, x.pair_ray, x.rays).numpy(),
                          keys.numpy())


def test_blocks_for_covers_each_pair_once(setup):
    """Each real row of blocks_for is one bin's run of at most RUN_PAIRS
    sorted pairs; together they cover every pair once, in order."""
    x, _ = setup
    blocks = binnedglue.blocks_for(x.sortd_s, x.n_bins).numpy()
    sortd = x.sortd_s.numpy()
    real = blocks[blocks[:, 0] >= 0]
    covered = np.concatenate([np.arange(s, s + c) for _, s, c in real])
    assert np.array_equal(covered, np.arange(sortd.shape[0]))
    assert (real[:, 2] <= kb.RUN_PAIRS).all() and (real[:, 2] > 0).all()
    for b, s, c in real:
        assert (sortd[s:s + c] == b).all()


def test_unsort_and_decode_match_the_jax_query(setup):
    """The reduce of the first round's keys, decoded: on the rays without
    overflow, the hit masks, faces and t of pb.closest_hit (interpret mode,
    exact_t=False) equal at t rtol 2^-13, and the streamed core on every
    ray."""
    x, j = setup
    hit, t, slot = binnedglue.decode(binnedglue.unsort(x.keys, x.pair_ray, N))
    h_j, t_j, face_j = (np.asarray(a) for a in pb.closest_hit(
        j["cs"], j["ro"], j["rd"], T0, T1, exact_t=False, interpret=True))
    ok = ~x.ovf.numpy()
    hit = hit.numpy()
    assert h_j.any() and ok.mean() > 0.95
    assert np.array_equal(hit[ok], h_j[ok])
    face = binnedglue.slot_to_face(x.cs, slot).numpy()
    assert np.array_equal(face[ok & hit], face_j[ok & hit])
    np.testing.assert_allclose(t.numpy()[ok & hit], t_j[ok & hit], rtol=2.0 ** -13)
    assert np.array_equal(binnedglue.core(x.cs, x.ro, x.rd, x.t1v, False).numpy()[ok], h_j[ok])
    assert np.array_equal(binnedglue.core(x.cs, x.ro, x.rd, x.t1v, True).numpy(), h_j)


def test_exact_t_and_slot_to_face_match_jax(setup):
    x, j = setup
    slot = jnp.asarray(x.slot.numpy())
    assert np.array_equal(binnedglue.slot_to_face(x.cs, x.slot).numpy(),
                          np.asarray(clj.slot_to_face(j["cs"], slot)))
    got = binnedglue.exact_t(x.cs, x.slot, x.ro, x.rd, x.t_leaf).numpy()
    want = np.asarray(clj.exact_t_for_slot(j["cs"], slot, j["ro"], j["rd"],
                                           jnp.asarray(x.t_leaf.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sweeps_match_the_jax_twin(setup):
    """resid_sweep (256 live rays) and sweep_sorted (the sweep's twins here)
    against JAX's closest_hit_ref hit masks."""
    x, j = setup
    h_j = np.asarray(clj.closest_hit_ref(j["cs"], j["ro"], j["rd"], T0, T1)[0])
    assert h_j.any()
    assert np.array_equal(binnedglue.sweep_sorted(x.cs, x.ro, x.rd, x.t1v).numpy(), h_j)
    live = np.arange(N) < binnedglue.RESID_LIVE
    resid = binnedglue.resid_sweep(x.cs, x.ro, x.rd, x.t1_resid).numpy()
    assert np.array_equal(resid[live], h_j[live]) and not resid[~live].any()


ROWS = ["pack_rays", "prepass", "sort_pairs", "leaf", "unsort", "decode", "peel",
        "blocks_for", "leaf_streamed", "exact_t", "slot_to_face", "resid_sweep",
        "core_resident", "core_streamed", "sweep_sorted"]


def test_main_on_the_cpu_prints_every_row(capsys):
    """Every row and one JSON line; no number for the JAX stages the port
    does not have; each binned stage counts its twin once a call."""
    assert binnedglue.main(["--device", "cpu", "--n", "512", "--res", "32",
                            "--reps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    for name in ROWS:
        assert any(line.startswith(name + " ") for line in out), name
    for name in ("ids_unpack", "take_cols", "sort3", "sort2", "scatter_unsort"):
        assert not any(line.startswith(name) for line in out)
    result = json.loads(out[-1])
    rows = {r["name"]: r for r in result["rows"]}
    assert list(rows) == ROWS and result["bins"] == 4
    assert rows["prepass"]["twin_calls"] == {"binned_prepass": 1}
    assert rows["leaf_streamed"]["twin_calls"] == {"binned_leaf_streamed": 1}
    assert rows["decode"]["twin_calls"] == {} and rows["decode"]["launches"] == {}


def test_binnedgran_child_at_bin_1(capsys):
    """One child at BIN = 1 (its own process): one row, 32 bins of one
    cluster on terrain res 32, full hit agreement with the sweep's twin."""
    assert binnedgran.main(["--device", "cpu", "--bins", "1", "--n", "512", "--res", "32",
                            "--reps", "1", "--timeout", "300"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    result = json.loads(out[-1])
    assert result["failed"] == [] and len(result["rows"]) == 1
    row = result["rows"][0]
    assert row["bin"] == 1 and row["bins"] == 16 and row["hit_agree"] == 1.0
    assert row["twin_calls"] == {"binned_prepass": 1, "binned_leaf": 1}
    assert any(line.startswith("BIN=1: bins=16") for line in out)
    # the child's whole-process counts, summed by the parent
    assert result["launches_total"] == {} and result["twin_calls_total"] == \
        row["twin_calls_total"] and result["twin_calls_total"]["binned_leaf"] > 1


@pytest.mark.parametrize("argv", [["--bins", "3"], ["--bins", "4", "--timeout", "0.01"]])
def test_binnedgran_exits_nonzero_when_a_child_fails(argv, capsys):
    """A child that fails (BIN = 3 divides no supercluster of 16 clusters)
    or outlives its timeout: the run ends, lists it as failed and exits 1."""
    assert binnedgran.main(["--device", "cpu", "--n", "256", "--res", "32", "--reps", "1",
                            *argv]) == 1
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert result["rows"] == [] and result["failed"] == [int(argv[1])]
    assert "FAILED" in err


def test_ptxas_report_names_each_leafs_bin():
    """The binned leaves are built for BIN = 1, 2 and 4: clusterbench's
    ptxas report tags each instantiation with its bin (and its leaves)."""
    from pyrenderer_tpu_torch.perf.clusterbench import ptxas_report

    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118binned_leaf_kernel"
        f"ILi{b}ELb{w}EEEvPKfPKiPKllS2_fPl' for 'sm_90a'\n"
        f"ptxas info    : Used {40 + b + w} registers"
        for b in kb.BIN_KERNELS for w in (0, 1))
    assert ptxas_report(log, "binned") == [
        f"ptxas binned_leaf_kernel bin {b} {('MT', 'watertight')[w]}: Used {40 + b + w} registers"
        for b in kb.BIN_KERNELS for w in (0, 1)]
