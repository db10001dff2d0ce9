"""Counter-based RNG: Threefry-2x32, keyed by (pixel, sample, bounce, use).

Counterpart of pyrenderer_tpu/rng.py, bit-exact against it and against the
NumPy oracle pyrenderer_tpu/ref/rng_np.py. Every uniform draw is a pure
function of ``(seed, pixel_id, sample_id, bounce, use)``; there is no
global generator state.

Counter layout (c0, c1 are the Threefry counter words):
    c0 = pixel_id                       (uint32: up to 4G pixels)
    c1 = (sample_id << 12) | (bounce << 4) | use
         sample_id: 20 bits (1M spp), bounce: 8 bits (256), use: 4 bits (16)

Key = (seed, 0x70617468)  ("path" tag).

Uniforms are ``(bits >> 8) * 2**-24`` computed in float32 and only then
cast to the working dtype, exactly as the JAX path and the oracle do.

On a CPU tensor, 32-bit words are carried in int64 tensors masked with
0xFFFFFFFF after every add and shift (``threefry2x32``, the plain twin):
PyTorch has no unsigned 32-bit shift on the CPU, and ``>>`` on int32 is an
arithmetic shift. On a CUDA tensor one evaluation is one launch of the
kernel of csrc/rng.cu (kernels/threefry.py), in uint32 registers, bit for
bit the twin's words and uniforms; the device of `pixel` chooses the path.
"""

from __future__ import annotations

import os

import torch

from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.kernels.threefry import threefry
from pyrenderer_tpu_torch.utils.profiling import span

# Use-slot assignments within one bounce (or the camera slot).
# Camera draws live at bounce = CAMERA_BOUNCE.
U_PIXEL_X = 0
U_PIXEL_Y = 1
U_LENS_X = 2
U_LENS_Y = 3
U_BSDF_0 = 4
U_BSDF_1 = 5
U_BSDF_2 = 6
U_LIGHT_PRIM = 7
U_LIGHT_FACE = 8
U_LIGHT_U = 9
U_LIGHT_V = 10
U_RR = 11
U_LIGHT_STRAT = 12

CAMERA_BOUNCE = 255

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_U32 = 0xFFFFFFFF
_KEY_TAG = 0x70617468
_SCALE = 1.0 / (1 << 24)

def _default_rounds() -> int:
    """The round count PYRENDERER_TF_ROUNDS asks for (20: Threefry's
    default; 13: the smallest count that passes BigCrush, Salmon et al.
    SC'11), read at every call, as the JAX package and the NumPy oracle
    read it. Subkeys are injected only after complete 4-round groups (the
    Random123 schedule)."""
    return int(os.environ.get("PYRENDERER_TF_ROUNDS", "20"))


def threefry2x32(k0, k1, c0, c1, rounds: int | None = None):
    """Threefry-2x32. Inputs are Python ints or int64 tensors holding uint32
    values; returns the two output words as int64 tensors in [0, 2**32)."""
    rounds = _default_rounds() if rounds is None else rounds
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _U32
    x1 = (c1 + ks[1]) & _U32
    for r_idx in range(rounds):
        i = r_idx // 4
        r = _ROTATIONS[i % 2][r_idx % 4]
        x0 = (x0 + x1) & _U32
        x1 = (((x1 << r) | (x1 >> (32 - r))) & _U32) ^ x0
        if (r_idx + 1) % 4 == 0:
            x0 = (x0 + ks[(i + 1) % 3]) & _U32
            x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def _words(seed: int, pixel, sample, bounce, use):
    """Both Threefry output words for the counter (pixel, sample, bounce,
    use). `pixel` is an integer tensor; the others broadcast against it."""
    with span("rng"):
        if build.on_cuda(pixel, "rng"):
            return tuple(threefry(seed, pixel, sample, bounce, use, _default_rounds(), 2,
                                  False))
        threefry.twin_calls += 1
        pixel = pixel.to(torch.int64) & _U32
        if torch.is_tensor(sample):
            sample = sample.to(torch.int64)
        c1 = ((sample << 12) | (bounce << 4) | use) & _U32
        return threefry2x32(seed & _U32, _KEY_TAG, pixel, c1)


def _to_unit(bits, dtype):
    return ((bits >> 8).to(torch.float32) * _SCALE).to(dtype)


def uniform_bits(seed: int, pixel, sample, bounce, use):
    """Random 32-bit words (int64 tensor) for each element of `pixel`."""
    return _words(seed, pixel, sample, bounce, use)[0]


def uniform(seed: int, pixel, sample, bounce, use, dtype=torch.float32):
    """Uniform in [0, 1) from the top 24 bits of the first output word."""
    if build.on_cuda(pixel, "rng"):
        with span("rng"):
            (u,) = threefry(seed, pixel, sample, bounce, use, _default_rounds(), 1, True)
        return u.to(dtype)
    return _to_unit(uniform_bits(seed, pixel, sample, bounce, use), dtype)


def uniform2(seed: int, pixel, sample, bounce, use, dtype=torch.float32):
    """Two uniforms from ONE Threefry call (both output words), addressed by
    the first use-slot of the pair -- as the JAX path and the oracle do."""
    if build.on_cuda(pixel, "rng"):
        with span("rng"):
            u0, u1 = threefry(seed, pixel, sample, bounce, use, _default_rounds(), 2, True)
        return u0.to(dtype), u1.to(dtype)
    x0, x1 = _words(seed, pixel, sample, bounce, use)
    return _to_unit(x0, dtype), _to_unit(x1, dtype)
