"""pyrenderer_tpu_torch -- the path tracer of pyrenderer_tpu on PyTorch and CUDA.

A port of the JAX package ``pyrenderer_tpu`` beside it, which stays the
reference. Plain tensor code is PyTorch; the whole-table intersection
kernels are CUDA C++ for Hopper (csrc/intersect.cu), built with nvcc at
first use and bound with ctypes. On CPU tensors every kernel is replaced
by its plain PyTorch twin.

Ported so far: the Cornell-box main path with the "reference" estimator --
scene loading, the Threefry RNG, camera rays, the wavefront integrator,
the progressive driver, tone mapping, PNG/EXR output and the CLI
(``python -m pyrenderer_tpu_torch scene.json --estimator reference``).
"""

__version__ = "0.1.0"

from pyrenderer_tpu_torch.config import RenderConfig  # noqa: F401
from pyrenderer_tpu_torch.scene.types import Camera, Scene, to_device  # noqa: F401
