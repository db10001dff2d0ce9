"""Build the CUDA kernels of csrc/ into a shared library and load it.

nvcc compiles every ``csrc/*.cu`` (one nvcc process per source, all at
once) and links them into one library with a plain C interface (no
PyTorch headers, so the build takes seconds), which ctypes loads. The
library's name carries a hash of the sources and flags: an edited ``.cu``
builds a new library, an unchanged one is reused. The build happens at
first use, never at import, so the package imports on machines without
nvcc or a GPU.

The build directory is ``<checkout>/build/kernels`` (``build/`` is in
.gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"

# -fmad=false: no a*b - c*d contracted into an FMA, and no fast-math flag
# (so 1/det is the IEEE quotient). The kernels then agree with their eager
# PyTorch twins, which never fuse, on which face a ray hits.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
_log = ""


BUILD_DIR = CSRC.parent.parent / "build" / "kernels"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of pyrenderer_tpu_torch cannot be built on this machine")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib) -> None:
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.pr_closest_hit.argtypes = [p, i32, p, p, p, f32, f32, i64, p, p, p, p]
    lib.pr_closest_hit.restype = ctypes.c_int
    lib.pr_occluded.argtypes = [p, i32, p, p, p, f32, f32, i64, p, p]
    lib.pr_occluded.restype = ctypes.c_int
    lib.pr_cluster_closest.argtypes = [p, p, p, p, i32, p, f32, i64, i32, p, p, p]
    lib.pr_cluster_closest.restype = ctypes.c_int
    lib.pr_cluster_occluded.argtypes = [p, p, p, p, i32, p, f32, i64, i32, p, p]
    lib.pr_cluster_occluded.restype = ctypes.c_int
    lib.pr_binned_prepass.argtypes = [p, i32, p, f32, i64, i32, p, p, p, p]
    lib.pr_binned_prepass.restype = ctypes.c_int
    lib.pr_binned_peel.argtypes = [p, i32, i64, i32, p, p, p, p]
    lib.pr_binned_peel.restype = ctypes.c_int
    lib.pr_binned_leaf.argtypes = [p, p, p, i64, p, f32, i32, p, p]
    lib.pr_binned_leaf.restype = ctypes.c_int
    lib.pr_binned_leaf_streamed.argtypes = [p, p, i64, p, p, f32, i32, p, p]
    lib.pr_binned_leaf_streamed.restype = ctypes.c_int


def build() -> str:
    """Compile the library if it is not built yet; return its path.

    Raises RuntimeError with nvcc's output if the compiler fails."""
    global _log
    sources = _sources()
    out_dir = BUILD_DIR
    out = out_dir / f"libpyrenderer_kernels_{_digest()}.so"
    if out.exists():
        return str(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # build in a private directory, then rename: a concurrent build never
    # sees (or loads) a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        # one nvcc per source, all started together, then one link
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        _log = "".join(logs)
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return str(out)


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory report) of the last
    build in this process; empty if the library was already built."""
    return _log


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
    return _lib


def launch_context(device):
    """(the loaded library, the handle of PyTorch's current stream on
    `device`): what every C entry point launches with."""
    return library(), torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
