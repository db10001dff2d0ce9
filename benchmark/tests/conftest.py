"""Shared fixtures of the benchmark's tests. Run them from the root of the
checkout: ``python -m pytest benchmark/tests -q`` (the tests marked
``cuda`` skip without a card)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="session")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


# the backend each configuration resolves to on a GPU, named for the CPU:
# there "auto" takes the BVH walk above 4,096 triangles, and "cluster" runs
# the sweep's plain twins
GPU_BACKEND = {"terrain100k": "cluster"}


def small_cell(name, bench, res=16):
    """Cell `name` with its configuration cut to res x res and its backend
    the one it resolves to on a GPU."""
    from benchmark import harness

    cell = harness.load_cell(name, copy.deepcopy(bench))
    cell.config["resolution"] = [res, res]
    cell.config["backend"] = GPU_BACKEND.get(cell.entry["config"], cell.config["backend"])
    return cell


@pytest.fixture
def run_small(monkeypatch, bench):
    """run(name, seed, seconds, trace, res=16): harness.run_cell on the CPU
    with the cell cut by small_cell."""
    from benchmark import harness

    def run(name, seed=7, seconds=0.5, trace=False, res=16):
        cell = small_cell(name, bench, res)
        monkeypatch.setattr(harness, "load_cell", lambda *a, **k: cell)
        return harness.run_cell(name, seed, seconds, trace, device="cpu")

    return run
