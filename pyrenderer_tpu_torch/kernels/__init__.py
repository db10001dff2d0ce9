"""The port's CUDA kernels (csrc/) behind their wrappers, and the launch
counts of every wrapper in one place."""

from __future__ import annotations


def wrappers():
    """Every kernel wrapper of the port, by the kernel's name: each counts
    the launches of its kernel (``.launches``) and, apart from them, the
    calls it served with its plain twin (``.twin_calls``)."""
    from pyrenderer_tpu_torch.kernels import (binned, cluster, film, intersect, pbrt,
                                              reference, threefry)
    from pyrenderer_tpu_torch.perf import kernelbench

    return {
        "closest_hit": intersect.closest_hit,
        "occluded": intersect.occluded,
        "cluster_closest_hit": cluster.closest_hit,
        "cluster_closest_suspend": cluster.suspend_pass,
        "cluster_closest_resume": cluster.resume_pass,
        "cluster_occluded": cluster.occluded,
        "binned_prepass": binned.prepass,
        "binned_peel": binned.peel,
        "binned_leaf": binned.leaf,
        "binned_leaf_streamed": binned.leaf_streamed,
        "kb_leaf": kernelbench.leaf,
        "kb_extract": kernelbench.extract,
        "kb_cond": kernelbench.cond,
        "kb_ctz": kernelbench.ctz,
        "threefry": threefry.threefry,
        "pbrt_hit": pbrt.hit,
        "pbrt_scatter": pbrt.scatter,
        "reference_hit": reference.hit,
        "reference_nee": reference.nee,
        "film": film.write,
    }


def reset_counters() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        fn.twin_calls = 0


def counts():
    """(launches, twin calls) of every wrapper since the last
    reset_counters(), as {kernel name: count} with the nonzero counts only."""
    fns = wrappers()
    return ({name: fn.launches for name, fn in fns.items() if fn.launches},
            {name: fn.twin_calls for name, fn in fns.items() if fn.twin_calls})
