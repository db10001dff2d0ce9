"""pyrenderer_tpu_torch native builders (tests/test_native.py's checks): the
port's own copies of the C++ sources, compiled with g++ into
build/native/, and their Python fallbacks."""

import numpy as np
import torch

from pyrenderer_tpu_torch import native
from pyrenderer_tpu_torch.accel import bvh as bvh_mod
from pyrenderer_tpu_torch.accel import clusters as cl
from pyrenderer_tpu_torch.scene.procgen import terrain
from tests.test_bvh import make_sphere_mesh

torch.set_num_threads(2)


def test_native_libraries_build_from_the_ports_sources():
    """Both libraries compile from pyrenderer_tpu_torch/native/*.cpp into
    build/native/ under the checkout, named by their sources' hashes."""
    for load, stem in ((native.load_library, "bvh_builder"),
                       (native.load_cluster_order_library, "cluster_order")):
        assert load() is not None, f"g++ compile of {stem}.cpp failed"
        assert (native.SRC_DIR / f"{stem}.cpp").exists()
        built = sorted(native.BUILD_DIR.glob(f"lib{stem}_*.so"))
        assert built and native._compile(native.SRC_DIR / f"{stem}.cpp") in built
    assert native.SRC_DIR.parent.name == "pyrenderer_tpu_torch"
    assert native.BUILD_DIR == native.SRC_DIR.parent.parent / "build" / "native"


def test_sah_structure_and_traversal_agreement():
    """The SAH tree covers every triangle once, escapes point forward, and
    its walk gives the LBVH walk's hits."""
    verts, faces = make_sphere_mesh(16, 24)
    sah = bvh_mod.build_bvh(verts, faces, method="sah")
    lbvh = bvh_mod.build_lbvh(verts, faces)
    first, count, order = sah.first.numpy(), sah.count.numpy(), sah.order.numpy()
    covered = [i for n in range(sah.n_nodes) if count[n] > 0
               for i in range(first[n], first[n] + count[n])]
    assert sorted(order[covered].tolist()) == list(range(faces.shape[0]))
    escape = sah.escape.numpy()
    assert escape[0] == -1 and all(e == -1 or e > i for i, e in enumerate(escape))

    def tris(b):
        v = torch.as_tensor(verts, dtype=torch.float32)
        ordered = torch.as_tensor(faces)[b.order.long()].long()
        v0 = v[ordered[:, 0]]
        return v0, v[ordered[:, 1]] - v0, v[ordered[:, 2]] - v0

    rs = np.random.RandomState(1)
    ro = torch.as_tensor(rs.uniform(-2, 2, (256, 3)), dtype=torch.float32)
    rd = rs.normal(size=(256, 3))
    rd = torch.as_tensor(rd / np.linalg.norm(rd, axis=1, keepdims=True), dtype=torch.float32)
    h1, t1, _ = bvh_mod.traverse(sah, *tris(sah), ro, rd, 1e-5, 1e5)
    h2, t2, _ = bvh_mod.traverse(lbvh, *tris(lbvh), ro, rd, 1e-5, 1e5)
    assert h1.any() and torch.equal(h1, h2)
    torch.testing.assert_close(t1[h1], t2[h1], rtol=1e-5, atol=0.0)


def test_sah_quality_not_worse():
    """The SAH tree's summed box surface is at most 1.1x the LBVH's."""
    verts, faces = make_sphere_mesh(16, 24)

    def cost(b):
        d = np.maximum(b.bbox_max.numpy() - b.bbox_min.numpy(), 0)
        return (2 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])).sum()

    assert cost(bvh_mod.build_bvh(verts, faces, method="sah")) <= \
        cost(bvh_mod.build_lbvh(verts, faces)) * 1.1


def test_cluster_order_native_matches_python(monkeypatch):
    """The C++ median-split orderer equals the Python recursion bit for bit
    (the same stable sorts, round-half-to-even split points)."""
    for res, leaf in [(64, 128), (97, 128), (64, 32)]:
        verts, faces = terrain(res)
        tri = np.asarray(verts, np.float64)[np.asarray(faces, np.int64)]
        cent = 0.5 * (tri.min(axis=1) + tri.max(axis=1))
        order = native.cluster_median_order_native(cent, leaf)
        assert order is not None and order.dtype == np.int64
        monkeypatch.setattr(native, "cluster_median_order_native", lambda c, leaf: None)
        assert np.array_equal(cl._median_split_order(cent, leaf), order), (res, leaf)
        monkeypatch.undo()


def test_build_clusters_uses_native_order(monkeypatch):
    """build_clusters gives the same ClusterScene through the native
    orderer and through the Python fallback."""
    verts, faces = terrain(48)
    calls = []
    orig = native.cluster_median_order_native
    monkeypatch.setattr(native, "cluster_median_order_native",
                        lambda c, leaf: calls.append(leaf) or orig(c, leaf))
    cs_native = cl.build_clusters(verts, faces)
    assert calls == [cl.LANE_TRIS]
    monkeypatch.setattr(native, "cluster_median_order_native", lambda c, leaf: None)
    cs_python = cl.build_clusters(verts, faces)
    for name in ("tri", "child_box", "super_cols", "order", "bin_box"):
        torch.testing.assert_close(getattr(cs_native, name), getattr(cs_python, name),
                                   rtol=0, atol=0, equal_nan=True)
