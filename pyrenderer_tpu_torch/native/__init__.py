"""Native host-side builders (C++ via ctypes).

Counterpart of pyrenderer_tpu/native/__init__.py, with the port's own copies
of its two sources: ``bvh_builder.cpp`` (12-bucket SAH BVH in the flat
escape-pointer layout of accel/bvh.py) and ``cluster_order.cpp`` (the
median-split order of accel/clusters.py, bit-identical to its Python
recursion). Each is compiled with the system g++ at first use into
``<checkout>/build/native`` (``build/`` is in .gitignore), under a name that
carries a hash of the source, and loaded with ctypes. The compile goes to a
private file that is then renamed, so that processes building at once never
load a half-written library.

Both are optional, as in the JAX package: a loader returns None when g++
or the library is unavailable, and the callers fall back to Python
(accel/bvh.build_lbvh, accel/clusters' Python median split).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs = {}


def _compile(src: Path) -> Optional[Path]:
    """The shared library of `src`, compiled if it is not built yet; None if
    g++ fails or is missing."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(src)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    except (OSError, subprocess.SubprocessError):
        return None
    return out


def _load(stem: str, declare):
    """The ctypes library of `stem`.cpp with its functions declared, or
    None; tried once per process."""
    with _lock:
        if stem not in _libs:
            path = _compile(SRC_DIR / f"{stem}.cpp")
            lib = None
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                    declare(lib)
                except OSError:
                    lib = None
            _libs[stem] = lib
    return _libs[stem]


def _declare_bvh(lib) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.build_sah_bvh.restype = ctypes.c_int32
    lib.build_sah_bvh.argtypes = [f32p, f32p, ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, i32p, f32p, f32p, i32p, i32p, i32p]


def _declare_cluster_order(lib) -> None:
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.cluster_median_order.restype = ctypes.c_int32
    lib.cluster_median_order.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64, i64p]


def load_library():
    """The SAH builder's ctypes library, or None when it cannot be built."""
    return _load("bvh_builder", _declare_bvh)


def load_cluster_order_library():
    """The median-split orderer's ctypes library, or None."""
    return _load("cluster_order", _declare_cluster_order)


def build_sah_bvh_native(tri_min, tri_max, leaf_size: int = 4):
    """SAH build through the C++ library: a dict of the flat node arrays
    (order, bbox_min, bbox_max, first, count, escape), or None when the
    library cannot be built or loaded."""
    lib = load_library()
    if lib is None:
        return None
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    t = tri_min.shape[0]
    max_nodes = 4 * t + 1
    order = np.empty(t, np.int32)
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    escape = np.empty(max_nodes, np.int32)
    n = lib.build_sah_bvh(tri_min, tri_max, t, leaf_size, max_nodes,
                          order, bmin, bmax, first, count, escape)
    if n < 0:
        return None
    return dict(order=order, bbox_min=bmin[:n], bbox_max=bmax[:n], first=first[:n],
                count=count[:n], escape=escape[:n])


def cluster_median_order_native(cent, leaf_size: int):
    """Median-split cluster order through C++ (bit-identical to the Python
    recursion of accel/clusters._median_split_order): (T,) int64, or None
    when the library is unavailable."""
    lib = load_cluster_order_library()
    if lib is None:
        return None
    cent = np.ascontiguousarray(cent, np.float64)
    t = cent.shape[0]
    order = np.empty(t, np.int64)
    if lib.cluster_median_order(cent, t, int(leaf_size), order) != 0:
        return None
    return order
