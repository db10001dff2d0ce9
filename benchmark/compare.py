"""The comparison that decides `correct`: the numbers a run is judged by,
each beside its limit.

A render cell is judged by its film after the window: at pixels drawn from
the seed, each pixel's radiance sum against the plain reference's sum of
the same samples, and the film's sample count at every pixel against the
passes the harness ran. The program and the reference trace the same
paths, so their sums agree to rounding; but a last-bit difference of a hit
or a direction (another order of operations, a fused kernel, another
device's libm) sends a path elsewhere, and a sound program differs in a
few samples of many pixels. So a pixel is judged against the reference's
Monte-Carlo standard error, which a few such samples cannot reach, and the
image's total is judged against the reference's to a small share, which a
biased or altered radiance does not meet.
"""

from __future__ import annotations

import numpy as np

# a pixel is off when a channel of its sum lies more than Z of the
# reference's standard errors from the reference's sum; the per-sample
# variance is taken at least VAR_FLOOR (0.01 radiance squared), so a pixel
# whose samples agree is not judged by a vanishing error
Z = 5.0
VAR_FLOOR = 1e-4


def film_numbers(film_sum, film_spp, reference, n_samples: int) -> dict:
    """{name: value} of a film against the reference.

    film_sum: (P, 3) radiance sums at the compared pixels; film_spp: the
    film's samples at every pixel; reference(): the reference's (P, 3)
    sums and sums of squares of the same samples, called only when every
    pixel holds n_samples (the passes the harness ran, each one sample a
    pixel):
      spp_gap        the largest gap between a pixel's samples and n_samples
      outlier_share  the share of compared pixels off by more than Z
                     standard errors of the reference's sum
      mean_gap       |sum of the film - sum of the reference| / the
                     reference's, over every compared pixel and channel
    A film with a gap is not compared with the reference (its two other
    numbers are None, which fails).
    """
    gap = float(np.abs(np.asarray(film_spp, np.int64) - n_samples).max())
    if gap:
        return {"spp_gap": gap, "outlier_share": None, "mean_gap": None}
    r_sum, r_sq = (np.asarray(x, np.float64) for x in reference())
    f = np.asarray(film_sum, np.float64)
    var = np.maximum(r_sq / n_samples - (r_sum / n_samples) ** 2, VAR_FLOOR)
    z = np.abs(f - r_sum) / np.sqrt(n_samples * var)
    return {
        "spp_gap": gap,
        "outlier_share": float((z.max(axis=1) > Z).mean()),
        "mean_gap": float(abs(f.sum() - r_sum.sum()) / max(abs(r_sum.sum()), 1e-30)),
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit; a number that is None or not finite fails."""
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    correct = all(c["value"] is not None and np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


# a leaf whose reference gradient is under SMALL_GRAD of the median leaf's
# moves by round-off alone (the emission, which the reference estimator
# never reads, has none): it is left out of the gradient and change gaps
SMALL_GRAD = 1e-3


def _leaf_gap(prog, ref, kept, scale=None):
    """The widest gap between a kept leaf's norm in the program and in the
    reference, against `scale` (default: the larger of the reference
    leaf's norm and the median kept leaf's)."""
    ref_n = [float(torch_norm(r)) for r in ref]
    if scale is None:
        med = float(np.median([ref_n[i] for i in kept]))
        scale = [max(n, med, 1e-30) for n in ref_n]
    return float(max(abs(float(torch_norm(prog[i])) - ref_n[i]) / scale[i] for i in kept))


def torch_norm(x):
    return np.linalg.norm(np.asarray(x, np.float64).reshape(-1))


def train_numbers(prog: dict, ref: dict, lr) -> dict:
    """{name: value} of the program's first steps against the reference's.

    prog, ref: "losses" (one a step), "params" (the parameters before the
    first step, after it, and after the last compared step; host arrays);
    ref also "grads": the reference's first gradient of each leaf, which
    picks the leaves compared (SMALL_GRAD) and scales their gaps.
      loss_gap    the widest relative gap of a step's loss
      grad_gap    the first gradient as the optimizer got it, (p0 - p1) / lr
                  from each side's state, leaf by leaf (_leaf_gap)
      change_gap  the parameters' change p_last - p0, leaf by leaf
    """
    norms = [torch_norm(g) for g in ref["grads"]]
    med = float(np.median(norms))
    kept = [i for i, n in enumerate(norms) if n >= SMALL_GRAD * med]

    def diff(a, b, scale=(1.0, 1.0, 1.0)):
        return [(np.asarray(x, np.float64) - np.asarray(y, np.float64)) / r
                for x, y, r in zip(a, b, scale)]

    (p0, p1, pn), (q0, q1, qn) = prog["params"], ref["params"]
    scale = [max(n, med, 1e-30) for n in norms]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _leaf_gap(diff(p0, p1, lr), diff(q0, q1, lr), kept, scale),
        "change_gap": _leaf_gap(diff(pn, p0), diff(qn, q0), kept, None),
    }
