"""Multi-process execution: the torch.distributed world and whole frames
rendered over it.

Counterpart of pyrenderer_tpu/dist/multihost.py. The JAX package runs one
SPMD program over every process's devices (jax.distributed); here every
process is one rank with one device, and the ranks meet in a
torch.distributed process group.

  initialize(...)        -- the process group from arguments or the
                            environment (PYRT_COORDINATOR,
                            PYRT_NUM_PROCESSES, PYRT_PROCESS_ID); for one
                            process a world of one.
  rank_device(cpu)       -- this rank's device.
  make_host_mesh(...)    -- the ("dp", "sp") mesh over the world, dp-major in
                            rank order.
  render_image_multihost -- a whole frame: each rank renders its pixel
                            block, an all-gather over "dp" gives every rank
                            the frame.

NCCL takes one rank per GPU (two ranks on one device are refused), so more
ranks than GPUs run over gloo, asked for explicitly: the kernels still run
on the card, and the collectives pass through host memory.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pyrenderer_tpu_torch.config import RenderConfig
from pyrenderer_tpu_torch.core.camera import generate_rays
from pyrenderer_tpu_torch.core.integrator import TraceTables, trace_reference
from pyrenderer_tpu_torch.dist.render import (
    all_reduce,
    dp_block,
    gather_dp,
    make_mesh,
    pixel_grid,
    render_field_sharded,
)
from pyrenderer_tpu_torch.scene.types import Camera, Scene


def _local_rank(process_id: int) -> int:
    """The rank's index among the processes of its host: LOCAL_RANK where a
    launcher sets it, else the process id (the processes of one host)."""
    return int(os.environ.get("LOCAL_RANK", process_id))


def rank_device(cpu: bool = False) -> torch.device:
    """This rank's device: the CPU when asked for, else
    cuda:{local rank % the GPUs of the host}."""
    if cpu:
        return torch.device("cpu")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device: str | None = None) -> bool:
    """Bring up the torch.distributed process group from the arguments or
    the environment (PYRT_COORDINATOR, PYRT_NUM_PROCESSES,
    PYRT_PROCESS_ID). Returns True if a multi-process world was initialized.

    coordinator: "host:port" of process 0 (a TCP rendezvous), or any
    init_method URL such as "file:///path". device: "cpu" for ranks on the
    CPU; by default the ranks use the GPUs (rank_device), and there must be
    one. backend: None means "nccl" for GPU ranks and "gloo" for CPU ranks.
    NCCL takes one rank per GPU: with more processes than the host's GPUs
    this raises unless backend="gloo" is asked for; it never swaps in gloo
    itself.

    With one process (num_processes unset or 1) it brings up a world of one
    over an in-memory store, if no group is up, and returns False: a torch
    mesh needs a process group, where JAX's covers one process's devices
    without one."""
    coordinator = coordinator or os.environ.get("PYRT_COORDINATOR")
    if num_processes is None and "PYRT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PYRT_NUM_PROCESSES"])
    if process_id is None and "PYRT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PYRT_PROCESS_ID"])
    n = num_processes or 1
    cpu = device == "cpu"
    if device not in (None, "cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for ranks on the CPU")
    backend = backend or ("gloo" if cpu else "nccl")
    if backend == "nccl":
        if cpu:
            raise ValueError("NCCL moves CUDA tensors: CPU ranks take backend='gloo'")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; pass backend='gloo'")
        if n > torch.cuda.device_count():
            raise ValueError(
                f"NCCL takes one rank per GPU: {n} ranks on {torch.cuda.device_count()} "
                "GPU(s); pass backend='gloo' for ranks that share a GPU")
    if n <= 1:
        if not dist.is_initialized():
            if not cpu:
                torch.cuda.set_device(rank_device())
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return False
    if coordinator is None or process_id is None:
        raise ValueError("a multi-process world needs the coordinator and the process id")
    if not cpu:
        torch.cuda.set_device(torch.device(
            "cuda", _local_rank(process_id) % torch.cuda.device_count()))
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=process_id)
    return True


def make_host_mesh(dp: int | None = None, sp: int | None = None) -> DeviceMesh:
    """The ("dp", "sp") mesh over every rank of the world, dp-major in rank
    order: each process owns a contiguous band of pixel blocks, and the
    sample sum of a block stays among consecutive ranks."""
    return make_mesh(dp=dp, sp=sp)


def _global_pixel_arrays(camera: Camera, mesh: DeviceMesh):
    """This rank's dp block of the row-major pixel coordinates, on the
    camera's device. Every rank computes its own block: no data moves."""
    px, py = pixel_grid(camera)
    block = dp_block(mesh, px.shape[0])
    return px[block], py[block]


@torch.no_grad()
def render_image_multihost(scene: Scene, camera: Camera, cfg: RenderConfig,
                           mesh: DeviceMesh | None = None):
    """Full-frame HDR render over the mesh (make_host_mesh by default).

    Returns the assembled (H, W, 3) image as a NumPy array on every rank
    (an all-gather of the dp blocks), row 0 at the top."""
    if mesh is None:
        mesh = make_host_mesh()
    w, h = camera.resolution
    px, py = pixel_grid(camera)
    block = render_field_sharded(scene, camera, cfg, mesh, px, py)
    img = gather_dp(block, mesh).cpu().numpy().reshape(h, w, 3)
    return np.ascontiguousarray(img[::-1])  # y-up pixel convention -> row 0 at top


@torch.no_grad()
def _count_rays(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: DeviceMesh, px, py):
    """The Mrays/s numerator of one sample on the sharded path: the live
    closest-hit and NEE shadow rays of this rank's pixel block (px, py from
    _global_pixel_arrays), summed over "dp" only: every sp rank traces the
    same sample here. A float, the same on every rank."""
    w, _ = camera.resolution
    pid = py.to(torch.int64) * w + px.to(torch.int64)
    ro, rd = generate_rays(camera, px, py, 0, cfg.seed)
    tables = TraceTables(scene, cfg, "auto")
    _, n_rays = trace_reference(scene, cfg, ro, rd, pid, 0, cfg.seed, tables=tables,
                                with_stats=True)
    return float(all_reduce(n_rays, mesh.get_group("dp")))
