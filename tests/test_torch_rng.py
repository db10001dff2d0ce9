"""pyrenderer_tpu_torch.rng: bit-exact against the JAX RNG and the NumPy oracle."""

import ctypes

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


# ------------------------------------------------- the CUDA kernel's wrapper

def _emulated_launch(calls):
    """A stand-in for build.launch that runs pr_threefry's contract in NumPy
    on the host memory the wrapper points it at: operand pointers and
    strides, the int64 bits of `wide`, c1_const, the rounds, both output
    modes. Records each call's (n, rounds, unit, words)."""

    def launch(fn_name, device, *args):
        assert fn_name == "pr_threefry" and device.type == "cpu"
        *ops, wide, c1_const, k0, rounds, n, unit, out0, out1 = args
        assert n > 0

        def lanes(ptr, stride, bit):
            if ptr is None:
                return np.uint32(0)
            ctype, dt = ((ctypes.c_int64, np.int64) if wide >> bit & 1
                         else (ctypes.c_int32, np.int32))
            buf = np.frombuffer((ctype * ((n - 1) * stride + 1)).from_address(ptr), dt)
            return buf[::stride] if stride else np.repeat(buf, n)

        pixel, sample, bounce, use = (lanes(ops[2 * i], ops[2 * i + 1], i) for i in range(4))
        with np.errstate(over="ignore"):
            c1 = (np.uint32(c1_const) | (np.asarray(sample).astype(np.uint32) << np.uint32(12))
                  | (np.asarray(bounce).astype(np.uint32) << np.uint32(4))
                  | np.asarray(use).astype(np.uint32))
            words = rng_np.threefry2x32(k0, rng._KEY_TAG, np.asarray(pixel).astype(np.uint32),
                                        c1, rounds=rounds)
        for ptr, w in zip((out0, out1), words):
            if ptr is None:
                continue
            if unit:
                val = (w >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24)
                dst = np.frombuffer((ctypes.c_float * n).from_address(ptr), np.float32)
            else:
                val = w.astype(np.int64)
                dst = np.frombuffer((ctypes.c_int64 * n).from_address(ptr), np.int64)
            dst[:] = np.broadcast_to(val, (n,))
        calls.append((n, rounds, unit, 1 + (out1 is not None)))

    return launch


def _operand_cases():
    """(name, pixel, sample, bounce, use) as the callers hand them over: an
    expanded int64 pixel and a scalar sample (core/integrator.py), int32
    pixels, per-lane samples of both widths, an expanded and a strided
    sample, per-lane bounce and use, a CPU scalar sample, a 2-D grid, the
    counter fields at their maxima, one lane and none."""
    pixel, sample, bounce, use = (_t(a) for a in _counters(333, 5))
    top = torch.tensor([2**32 - 1, 0, 2**31], dtype=torch.int64)
    return [
        ("expanded_pixel", torch.tensor(77).expand(333), 9, 1, rng.U_BSDF_0),
        ("int64_scalar_sample", pixel, 5, 3, rng.U_LIGHT_U),
        ("int32_pixel", pixel.to(torch.int32), sample.to(torch.int32), 0, 7),
        ("lane_sample", pixel, sample, 2, 1),
        ("expanded_sample", pixel, torch.tensor(2**20 - 1).expand(333), 255, 15),
        ("strided_sample", pixel, _t(np.arange(666))[::2], 4, 2),
        ("lane_bounce_use", pixel.to(torch.int32), sample, bounce.to(torch.int32), use),
        ("cpu_scalar_sample", pixel, torch.tensor(12), rng.CAMERA_BOUNCE, rng.U_PIXEL_X),
        ("grid", pixel[:300].reshape(20, 15), sample[:15], 1, 4),
        ("maxima", top, 2**20 - 1, 255, 15),
        ("one_lane", pixel[:1], 3, 1, 1),
        ("no_lanes", pixel[:0], sample[:0], 1, 1),
    ]


@pytest.mark.parametrize("rounds", [13, 20, 8])
@pytest.mark.parametrize("case", _operand_cases(), ids=lambda c: c[0])
def test_kernel_operands_on_an_emulated_launch(case, rounds, monkeypatch):
    """The CUDA wrapper's operands, run through a NumPy stand-in of the
    kernel's contract on the CPU: every shape, width and stride the callers
    hand over gives the twin's words and uniforms, one launch an evaluation
    (none for no lanes), the rounds read at the call, and one rng_kernel
    count a launch."""
    from pyrenderer_tpu_torch.kernels import build, reset_counters
    from pyrenderer_tpu_torch.kernels.threefry import threefry
    from pyrenderer_tpu_torch.utils import profiling

    _, pixel, sample, bounce, use = case
    monkeypatch.setenv("PYRENDERER_TF_ROUNDS", str(rounds))
    want0, want1 = rng._words(7, pixel, sample, bounce, use)
    calls = []
    monkeypatch.setattr(build, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(build, "launch", _emulated_launch(calls))
    reset_counters()
    with profiling.recording("cpu") as rec:
        with profiling.span("pass"):
            x0, x1 = rng._words(7, pixel, sample, bounce, use)
            bits = rng.uniform_bits(7, pixel, sample, bounce, use)
            u = rng.uniform(7, pixel, sample, bounce, use)
            u0, u1 = rng.uniform2(7, pixel, sample, bounce, use, torch.float64)
    assert x0.dtype == x1.dtype == bits.dtype == torch.int64
    assert torch.equal(x0, want0) and torch.equal(x1, want1) and torch.equal(bits, want0)
    assert torch.equal(u, rng._to_unit(want0, torch.float32))
    assert torch.equal(u0, rng._to_unit(want0, torch.float64))
    assert torch.equal(u1, rng._to_unit(want1, torch.float64))
    n = want0.numel()
    assert calls == ([(n, rounds, 0, 2)] * 2 + [(n, rounds, 1, 1), (n, rounds, 1, 2)]
                     if n else [])
    assert threefry.launches == len(calls) and threefry.twin_calls == 0
    assert rec.counters == ({"rng_kernel": 4} if n else {})
    assert rec.summary("pass")["rng_kernel"] == len(calls)
    reset_counters()


def test_kernel_refuses_operands_on_another_device(monkeypatch):
    """A per-lane counter operand that is not on the pixels' device raises
    (a CPU scalar is folded into the counter instead)."""
    from pyrenderer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "on_cuda", lambda x, name: True)
    pixel = torch.arange(8, device="meta")
    with pytest.raises(ValueError, match="sample"):
        rng.uniform(1, pixel, torch.arange(8), 1, 1)


def test_cpu_never_loads_the_kernel_library(monkeypatch):
    """On CPU tensors the twin runs and the kernel library is never asked
    for: with build.library raising, every draw still equals the NumPy
    oracle's, each evaluation counts a twin call of the kernel's wrapper
    and no launch, and no rng_kernel is counted."""
    from pyrenderer_tpu_torch.kernels import build, counts, reset_counters
    from pyrenderer_tpu_torch.utils import profiling

    def refuse():
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(build, "library", refuse)
    pixel, sample, bounce, use = _counters(256, 8)
    args_t = (_t(pixel), _t(sample), _t(bounce), _t(use))
    reset_counters()
    with profiling.recording("cpu") as rec:
        with profiling.span("pass"):
            bits = _u32(rng.uniform_bits(9, *args_t))
            u = rng.uniform(9, *args_t).numpy()
            a, b = (x.numpy() for x in rng.uniform2(9, *args_t))
    assert np.array_equal(bits, rng_np.uniform_bits(9, pixel, sample, bounce, use))
    assert np.array_equal(u, rng_np.uniform(9, pixel, sample, bounce, use, np.float32))
    na, nb = rng_np.uniform2(9, pixel, sample, bounce, use, np.float32)
    assert np.array_equal(a, na) and np.array_equal(b, nb)
    assert rec.counters == {} and rec.summary("pass")["rng_kernel"] == 0.0
    assert counts() == ({}, {"threefry": 3})
    reset_counters()


# ---------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [13, 20])
def test_kernel_bit_exact_on_gpu(rounds, monkeypatch):
    """On a CUDA device (run with `python -m pytest tests/test_torch_rng.py
    -m cuda`): the kernel's words and uniforms equal the twin's
    (threefry2x32 on the same CUDA operands) and the NumPy oracle's, bit
    for bit, at 13 and 20 rounds through PYRENDERER_TF_ROUNDS; int32 and
    int64 pixels, contiguous and expanded, scalar and per-lane samples,
    per-lane bounce and use, the counter fields at their maxima, n = 0, 1
    and not a multiple of the block; one launch an evaluation, none for
    no lanes, and no twin call."""
    from pyrenderer_tpu_torch.kernels import counts, reset_counters
    from pyrenderer_tpu_torch.utils import profiling

    dev = _cuda()
    monkeypatch.setenv("PYRENDERER_TF_ROUNDS", str(rounds))
    pixel, sample, bounce, use = _counters(70_001, rounds)
    pixel[:3] = [2**32 - 1, 0, 2**31]
    sample[:3] = 2**20 - 1
    bounce[:3], use[:3] = 255, 15
    p64, s64 = _t(pixel).to(dev), _t(sample).to(dev)
    b64, u64 = _t(bounce).to(dev), _t(use).to(dev)
    cases = [
        (p64, s64, b64, u64),
        (p64.to(torch.int32), s64.to(torch.int32), b64.to(torch.int32), u64),
        (p64, 2**20 - 1, 255, 15),
        (p64.to(torch.int32), torch.tensor(5, device=dev), 1, rng.U_BSDF_0),
        (torch.tensor(2**32 - 1, device=dev).expand(70_001), s64, 2, 3),
        (p64[:257], s64[:257], 4, 5),
        (p64[:1], 0, rng.CAMERA_BOUNCE, rng.U_PIXEL_X),
        (p64[:0], 3, 1, 1),
    ]
    for seed in (0, 2**32 + 5):
        for pix, smp, bnc, use_ in cases:
            c1 = ((smp.to(torch.int64) if torch.is_tensor(smp) else smp) << 12
                  | bnc << 4 | use_) & rng._U32
            want0, want1 = (w.expand(pix.shape) for w in rng.threefry2x32(
                seed & rng._U32, rng._KEY_TAG, pix.to(torch.int64) & rng._U32, c1))
            reset_counters()
            with profiling.recording(dev) as rec:
                x0, x1 = rng._words(seed, pix, smp, bnc, use_)
                u = rng.uniform(seed, pix, smp, bnc, use_)
                v0, v1 = rng.uniform2(seed, pix, smp, bnc, use_)
            torch.cuda.synchronize()
            launched = 3 if pix.numel() else 0
            assert counts() == ({"threefry": launched} if launched else {}, {})
            assert rec.counters.get("rng_kernel", 0) == launched
            assert rec.counters["syncs"] == 0
            assert torch.equal(x0, want0) and torch.equal(x1, want1)
            assert torch.equal(u, rng._to_unit(want0, torch.float32))
            assert torch.equal(v0, u) and torch.equal(v1, rng._to_unit(want1, torch.float32))
            o0, o1 = _oracle_words(seed, pix, smp, bnc, use_)
            assert np.array_equal(_u32(x0.cpu()), o0) and np.array_equal(_u32(x1.cpu()), o1)


def _oracle_words(seed, pixel, sample, bounce, use):
    """The NumPy oracle's two words for counter operands as the port takes
    them (tensors on any device, or ints), broadcast to the pixels."""
    shape = tuple(pixel.shape)

    def u32(x):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return np.broadcast_to(x.astype(np.int64).astype(np.uint32), shape)

    with np.errstate(over="ignore"):
        c1 = (u32(sample) << np.uint32(12)) | (u32(bounce) << np.uint32(4)) | u32(use)
        return rng_np.threefry2x32(seed & rng._U32, rng._KEY_TAG, u32(pixel), c1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_kernel_uniforms_in_every_dtype_on_gpu(dtype):
    """On a CUDA device: uniform and uniform2 in float32, float64 and
    bfloat16 equal the twin's _to_unit of the twin's words, and the NumPy
    oracle's uniforms where NumPy has the dtype."""
    dev = _cuda()
    pixel, sample, bounce, use = _counters(65_536, 11)
    args = tuple(_t(a).to(dev) for a in (pixel, sample, bounce, use))
    x0, x1 = rng.threefry2x32(123, rng._KEY_TAG, args[0],
                              (args[1] << 12 | args[2] << 4 | args[3]) & rng._U32)
    u = rng.uniform(123, *args, dtype=dtype)
    a, b = rng.uniform2(123, *args, dtype=dtype)
    assert u.dtype == a.dtype == b.dtype == dtype
    assert torch.equal(u, rng._to_unit(x0, dtype)) and torch.equal(a, u)
    assert torch.equal(b, rng._to_unit(x1, dtype))
    if dtype != torch.bfloat16:
        np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        na, nb = rng_np.uniform2(123, pixel, sample, bounce, use, np_dtype)
        assert np.array_equal(a.cpu().numpy(), na) and np.array_equal(b.cpu().numpy(), nb)
