"""Threefry-2x32 of the counter RNG: the CUDA kernel's wrapper.

The kernel (csrc/rng.cu) replaces no TPU kernel: the JAX package's RNG
(pyrenderer_tpu/rng.py) is jnp elementwise ops that XLA fuses into their
consumers. Eager PyTorch has no such fusion, so the plain twin
(rng.threefry2x32, int64 words masked after every add and shift) costs
~170 launches an evaluation; the kernel is one, in uint32 registers, bit
for bit the twin's words and uniforms.

rng.py chooses the path from the device of the pixels, as every wrapper
does: ``_words``, ``uniform`` and ``uniform2`` call ``threefry`` for a CUDA
tensor and run the twin for a CPU one, counting it in
``threefry.twin_calls``. ``threefry`` counts its launches
(``threefry.launches``) and, for the program's own tracing, one
``rng_kernel`` (utils/profiling.count) a launch.
"""

from __future__ import annotations

import torch

from pyrenderer_tpu_torch.kernels import build
from pyrenderer_tpu_torch.utils.profiling import count

_U32 = 0xFFFFFFFF


def _lanes(x, name, device):
    """A counter operand on the kernel's terms: (the tensor, 0) for a
    per-lane operand on the pixels' device, (None, its value) for a Python
    int or a CPU scalar."""
    if not torch.is_tensor(x):
        return None, int(x)
    if x.device == device:
        return x, 0
    if x.device.type == "cpu" and x.dim() == 0:
        return None, int(x)
    raise ValueError(f"threefry: {name} is a {tuple(x.shape)} tensor on {x.device}, "
                     f"the pixels are on {device}")


def threefry(seed, pixel, sample, bounce, use, rounds, n_words, unit):
    """The first `n_words` (1 or 2) output words of Threefry-2x32 under the
    key (seed, rng._KEY_TAG) for the counter (pixel, (sample << 12) |
    (bounce << 4) | use), `rounds` rounds, broadcast to one shape: as int64
    in [0, 2**32), or (unit) as their float32 uniforms (x >> 8) * 2**-24.
    One launch of csrc/rng.cu, none for no lanes. Per-lane operands are
    read through their strides (an expanded operand is a stride of 0);
    only a result of more than one dimension flattens its operands, copying
    where a view cannot. Never waits for the device."""
    dev = pixel.device
    ops, c1_const = {0: pixel}, 0
    for bit, (name, x, shift) in enumerate(
            (("sample", sample, 12), ("bounce", bounce, 4), ("use", use, 0)), start=1):
        t, v = _lanes(x, name, dev)
        if t is None:
            c1_const |= (v << shift) & _U32
        else:
            ops[bit] = t
    ops = {bit: t if t.dtype in (torch.int32, torch.int64) else t.to(torch.int64)
           for bit, t in ops.items()}
    # broadcast_tensors, not broadcast_shapes: the latter's first call
    # imports sympy (~1 s of set-up) and each later one costs ~40 us
    views = torch.broadcast_tensors(*ops.values())
    shape = views[0].shape
    # the flat operands stay referenced until the launch: a copy freed
    # before it could hand its memory to the outputs
    flat = [t if t.dim() == 1 else t.reshape(-1) for t in views]
    args, wide = [None, 0] * 4, 0
    for bit, t in zip(ops, flat):
        wide |= (t.dtype == torch.int64) << bit
        args[2 * bit:2 * bit + 2] = t.data_ptr(), t.stride(0)
    outs = [torch.empty(shape, dtype=torch.float32 if unit else torch.int64, device=dev)
            for _ in range(n_words)]
    n = outs[0].numel()
    if n:
        build.launch("pr_threefry", dev, *args, wide, c1_const, int(seed & _U32), rounds, n,
                     int(unit), outs[0].data_ptr(),
                     outs[1].data_ptr() if n_words == 2 else None)
        threefry.launches += 1
        count("rng_kernel")
    return outs


def reset_counters() -> None:
    threefry.launches = 0
    threefry.twin_calls = 0


reset_counters()
