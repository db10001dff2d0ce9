"""The harness on the CPU: each cell's traffic end to end at 16 x 16 through
the port's plain twins, the faults a render cell can have coming out as
not correct, a cell and a metric added as files and entries only, and the
run's refusals."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from conftest import ROOT, small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["cornell.render", "terrain100k.render", "cornell.train"])
def test_traffic_end_to_end(run_small, bench, name):
    res = run_small(name, seconds=0.3)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = harness.load_cell(name, bench)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    # the CPU twins and the reference run the same arithmetic
    assert all(c["value"] == 0.0 for c in res["checks"].values())


def test_traced_run(run_small):
    res = run_small("cornell.render", seconds=0.3, trace=True)
    assert res["correct"] is True
    # no device here: only the host span of the film is read
    assert set(res["metrics"]) == {"film_ms_per_pass.render"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert list(res)[-1] == "checks"


def _alter(monkeypatch, fault):
    """Break the timed path underneath the harness as `fault` says."""
    from pyrenderer_tpu_torch.render import driver

    if fault == "state_unchanged":
        # a pass that returns with the film as it was
        calls = {"n": 0}
        real = driver.ProgressiveRenderer.render_one_pass

        def one_pass(self):
            calls["n"] += 1
            if calls["n"] > 1:      # after the warm-up pass
                return
            real(self)

        monkeypatch.setattr(driver.ProgressiveRenderer, "render_one_pass", one_pass)
    elif fault == "half_batch":
        # half of each chunk's pixels traced, the others given their mean
        real = driver._render_pass

        def half(scene, camera, cfg, tables, first, n, px, py):
            k = max(px.shape[0] // 2, 1)
            s, q, rays = real(scene, camera, cfg, tables, first, n, px[:k], py[:k])
            fill = lambda x: torch.cat([x, x.mean(0, keepdim=True).expand(px.shape[0] - k, 3)])  # noqa: E731
            return fill(s), fill(q), rays

        monkeypatch.setattr(driver, "_render_pass", half)
    elif fault == "answer_altered":
        # every radiance altered where the estimator produces it
        real = driver.render_sample

        def altered(*a, **k):
            r, n = real(*a, **k)
            return r * 1.01, n

        monkeypatch.setattr(driver, "render_sample", altered)


def _alter_training(monkeypatch, fault):
    """Break train_step underneath the harness as `fault` says."""
    from pyrenderer_tpu_torch.dist import render

    real_step, real_grads = render.train_step, render.loss_and_grads
    if fault == "state_unchanged":
        # a step that returns the parameters it was given
        monkeypatch.setattr(render, "train_step",
                            lambda params, *a, **k: (real_step(params, *a, **k)[0], params))
    elif fault == "half_batch":
        # the first half of the pixels only, the mean taken over them
        def half(params, scene, camera, cfg, target, px, py, **k):
            n = px.shape[0] // 2
            return real_grads(params, scene, camera, cfg, target[:n], px[:n], py[:n], **k)

        monkeypatch.setattr(render, "loss_and_grads", half)
    elif fault == "answer_altered":
        # the loss altered where the step produces it
        def altered(*a, **k):
            loss, params = real_step(*a, **k)
            return loss * 1.01, params

        monkeypatch.setattr(render, "train_step", altered)


# the exchange between chips is not a fault a one-chip cell can have
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", ["cornell.render", "cornell.train"])
def test_fault_is_not_correct(run_small, monkeypatch, name, fault):
    (_alter if name.endswith("render") else _alter_training)(monkeypatch, fault)
    res = run_small(name, seconds=0.3)
    assert res["correct"] is False, (fault, res["checks"])


def test_new_cell_and_metric_as_files(tmp_path, bench):
    """A configuration, a traffic mix, a cell's checks and a per-layer
    metric added as files, and entries in BENCHMARK.json: the harness runs
    the cell and reads the metric with no edit of its code."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((here / "configs" / "cornell.json").read_text())
    cfg.update(resolution=[8, 8], max_bounces=2)
    (here / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (here / "traffic" / "dummy.json").write_text(json.dumps(
        {"driver": "progressive", "spp_step": 1, "chunk": 16, "warmup_passes": 2,
         "profile_passes": 1}))
    (here / "checks" / "dummy.dummy.json").write_text(json.dumps(
        {"compare_pixels": 64, "limits": {"spp_gap": 0, "outlier_share": 0.0}}))
    (here / "metrics" / "passes_profiled.dummy.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append(dict(b["configs"][0], name="dummy", file="benchmark/configs/dummy.json"))
    b["workloads"].append({"name": "dummy.dummy", "config": "dummy", "traffic": "dummy",
                           "chips": 1, "why": "a test"})
    b["end_to_end"][0]["workloads"].append("dummy.dummy")
    b["per_layer"].append({"name": "passes_profiled.dummy", "unit": "passes", "better": "higher",
                           "source": "program_counter", "layer": "film and driver",
                           "moves": "samples_per_s", "workloads": ["dummy.dummy"]})
    res = harness.run_cell("dummy.dummy", 3, 0.2, True, device="cpu", bench=b, here=here)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["passes_profiled.dummy"] == {"value": 1.0, "unit": "passes"}
    assert set(res["checks"]) == {"spp_gap", "outlier_share"}
    res = harness.run_cell("dummy.dummy", 3, 0.2, False, device="cpu", bench=b, here=here)
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}


def test_run_refuses_without_a_card():
    """No CUDA device here: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cornell.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cornell.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_card_check_before_any_work(monkeypatch):
    """run.main exits non-zero when the card count is short of the cell's."""
    from benchmark import run

    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: pytest.fail("ran without a card"))
    assert run.main(["--workload", "cornell.render", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0


def test_breakdown_labels_gaps_by_host_op():
    E = harness.Event
    events = [E("k1", 0.0, 1.0, True), E("k2", 3.0, 4.0, True), E("k3", 4.5, 5.0, True),
              E("aten::outer", 0.5, 4.2, False), E("aten::inner", 1.5, 2.5, False),
              E("cudaLaunchKernel", 1.9, 2.1, False)]
    b = harness.breakdown(events)
    assert [op[1] for op in b["device_ops"]] == [1.0, 1.0, 0.5]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle == {"aten::inner": 2.0, "(host outside any op)": 0.5}


def test_port_kernels_found_by_name():
    k = harness.port_kernels()
    assert {"closest_kernel", "anyhit_kernel"} <= k["intersect"]
    assert {"cluster_closest_kernel", "cluster_anyhit_kernel"} <= k["cluster"]
    assert harness.kernel_ident(
        "void (anonymous namespace)::closest_kernel<8>(float const*, int)") == "closest_kernel"
    assert harness.kernel_ident("Memcpy DtoH (Device -> Pageable)") == ""


def test_percentile():
    assert harness.percentile(np.arange(101), 90) == 90.0


def test_small_cell_cut(bench):
    cell = small_cell("terrain100k.render", bench, res=8)
    assert cell.config["resolution"] == [8, 8] and cell.config["backend"] == "cluster"
