"""pyrenderer_tpu_torch.rng: bit-exact against the JAX RNG and the NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrenderer_tpu import rng as rng_jax
from pyrenderer_tpu.ref import rng_np
from pyrenderer_tpu_torch import rng

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(x):
    return x.numpy().astype(np.uint32)


def _counters(n, seed):
    """Random (pixel, sample, bounce, use): sample ids past 2**19 and 2**20
    (the top of the 20-bit field wraps), bounces up to the camera slot 255."""
    rs = np.random.RandomState(seed)
    pixel = rs.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    sample = rs.randint(0, 2**21, n).astype(np.uint32)
    sample[:4] = [0, 2**19, 2**19 + 7, 2**20 - 1]
    bounce = rs.randint(0, 256, n).astype(np.uint32)
    bounce[:2] = 255
    use = rs.randint(0, 16, n).astype(np.uint32)
    return pixel, sample, bounce, use


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_bit_exact(rounds):
    rs = np.random.RandomState(rounds)
    k0, k1, c0, c1 = (rs.randint(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
                      for _ in range(4))
    t0, t1 = rng.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1), rounds=rounds)
    vec = jax.jit(jax.vmap(lambda a, b, c, d: rng_jax.threefry2x32(a, b, c, d, rounds=rounds)))
    j0, j1 = vec(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(c0), jnp.asarray(c1))
    assert np.array_equal(_u32(t0), np.asarray(j0))
    assert np.array_equal(_u32(t1), np.asarray(j1))
    n0, n1 = rng_np.threefry2x32(0, 0, c0, c1, rounds=rounds)
    z0, z1 = rng.threefry2x32(0, 0, _t(c0), _t(c1), rounds=rounds)
    assert np.array_equal(_u32(z0), n0) and np.array_equal(_u32(z1), n1)


def test_threefry_known_answer_13_rounds():
    """The canonical Random123 subkey schedule at 13 rounds (tests/test_rng.py)."""
    x0, x1 = rng.threefry2x32(1, 2, _t([3]), _t([4]), rounds=13)
    assert (int(x0[0]), int(x1[0])) == (1478547041, 2923887773)
    y0, y1 = rng.threefry2x32(1, 2, _t([3]), _t([4]), rounds=20)
    assert (int(y0[0]), int(y1[0])) != (1478547041, 2923887773)


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_uniform_streams_bit_exact(seed):
    """uniform_bits, uniform (f32 and f64) and uniform2 against both twins."""
    pixel, sample, bounce, use = _counters(512, seed % 97)
    args_t = (_t(pixel), _t(sample), _t(bounce), _t(use))
    args_j = tuple(jnp.asarray(a) for a in (pixel, sample, bounce, use))

    bits = _u32(rng.uniform_bits(seed, *args_t))
    assert np.array_equal(bits, np.asarray(rng_jax.uniform_bits(seed, *args_j)))
    assert np.array_equal(bits, rng_np.uniform_bits(seed, pixel, sample, bounce, use))

    u = rng.uniform(seed, *args_t).numpy()
    assert u.dtype == np.float32
    assert np.array_equal(u, np.asarray(rng_jax.uniform(seed, *args_j)))
    assert np.array_equal(u, rng_np.uniform(seed, pixel, sample, bounce, use, np.float32))
    u64 = rng.uniform(seed, *args_t, dtype=torch.float64).numpy()
    assert np.array_equal(u64, rng_np.uniform(seed, pixel, sample, bounce, use, np.float64))

    a, b = (x.numpy() for x in rng.uniform2(seed, *args_t))
    ja, jb = rng_jax.uniform2(seed, *args_j)
    na, nb = rng_np.uniform2(seed, pixel, sample, bounce, use, np.float32)
    assert np.array_equal(a, np.asarray(ja)) and np.array_equal(b, np.asarray(jb))
    assert np.array_equal(a, na) and np.array_equal(b, nb)


def test_rounds_read_at_call_time(monkeypatch):
    """PYRENDERER_TF_ROUNDS set after the port was imported takes effect:
    uniform at 13 rounds equals the NumPy oracle's 13-round draw and
    differs from the 20-round one."""
    pixel, sample, bounce, use = _counters(256, 3)
    args_t = (_t(pixel), _t(sample), _t(bounce), _t(use))
    u20 = rng.uniform(11, *args_t).numpy()
    monkeypatch.setenv("PYRENDERER_TF_ROUNDS", "13")
    u13 = rng.uniform(11, *args_t).numpy()
    assert np.array_equal(u13, rng_np.uniform(11, pixel, sample, bounce, use, np.float32))
    assert (u13 != u20).mean() > 0.99
    monkeypatch.delenv("PYRENDERER_TF_ROUNDS")
    assert np.array_equal(rng.uniform(11, *args_t).numpy(), u20)


def test_scalar_counters_broadcast():
    """Scalar sample/bounce/use broadcast against a pixel tensor, as the
    integrator calls it."""
    pixels = np.arange(1000, dtype=np.uint32)
    a = rng_np.uniform(42, pixels, 3, 2, 5, dtype=np.float32)
    b = rng.uniform(42, _t(pixels), 3, 2, 5).numpy()
    assert np.array_equal(a, b)
    assert 0.0 <= b.min() and b.max() < 1.0
