"""The benchmark harness: one cell of BENCHMARK.json, run from its data.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives:

    configs/<config>.json     the deployment (scene, resolution, bounces, ...)
    traffic/<traffic>.json    the traffic mix; its "driver" names
    drivers/<driver>.py       the window's driver, which a mix's numbers steer
    checks/<cell>.json        the comparison's sample size and its limits
    metrics/<metric>.py       a per-layer metric's reader, read(ctx) -> float | None

A driver module defines ``Driver(cell, seed, device)`` with ``setup()``
(build and warm up), ``window(seconds, tracer)``, ``end_to_end()`` (the
cell's end-to-end numbers by metric name), ``free()`` (drop the program's
state but what is judged), ``judge()`` (numbers compared, by name) and
``attempted`` / ``failed``. With ``--trace 1`` the driver profiles a
bounded number of whole units of work (passes, steps) through the tracer,
and the metric readers take the per-layer numbers from what it recorded.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import compare
from benchmark.metrics._trace import device_busy

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pyrenderer_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with the files its names point at."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list
    here: Path

    @property
    def driver(self):
        return load_module(self.here / "drivers" / f"{self.traffic['driver']}.py",
                           f"benchmark_driver_{self.traffic['driver']}")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    """The cell `name` of `bench` (default: BENCHMARK.json at the root of
    the checkout), its files read from `here`."""
    bench = load_json(here.parent / "BENCHMARK.json") if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = by_name[name]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(
        name=name, entry=entry,
        config=load_json(here / "configs" / f"{entry['config']}.json"),
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        checks=load_json(here / "checks" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, here=here)


def card_line(device) -> str:
    """The card's name, SM clock (now and its maximum), power limit and
    draw, and temperature, as nvidia-smi reads them."""
    if torch.device(device).type != "cuda":
        return "card: none (cpu)"
    q = "name,clocks.sm,clocks.max.sm,power.limit,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        line = f"nvidia-smi failed: {e!r}"
    return f"card: {line} ({q})"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------- tracing

_IDENT = re.compile(r"\b(\w+)(?=[<(])")


def kernel_ident(name: str) -> str:
    """A device event's function name without namespace, template and
    arguments ("void (anonymous namespace)::closest_kernel<8>(...)" ->
    "closest_kernel"); "" for copies and fills."""
    m = _IDENT.search(name)
    return m.group(1) if m else ""


def port_kernels() -> dict:
    """{csrc file stem: set of __global__ function names} of the program's
    CUDA sources, read at set-up, so a new kernel is counted without an
    edit here."""
    import pyrenderer_tpu_torch

    csrc = Path(pyrenderer_tpu_torch.__file__).resolve().parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    return {p.stem: set(pat.findall(p.read_text())) for p in sorted(csrc.glob("*.cu"))}


@dataclasses.dataclass
class Event:
    name: str
    start: float   # s, on the profiler's clock
    end: float
    device: bool


def _events(prof) -> list:
    """Every event of a finished torch.profiler session, device and host."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        out.append(Event(e.name(), s, s + e.duration_ns() * 1e-9,
                         e.device_type() == DeviceType.CUDA))
    return out


class Tracer:
    """torch.profiler around the driver's profiled units of work, and the
    host spans and program counters the driver records beside them.

    The per-layer metrics read units profiled with the device's activity
    alone (`begin()`), so that recording every host operation does not
    slow the units they time; the breakdown's idle gaps, which need the
    host's operations, read one more unit profiled with both
    (`begin(host=True)`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.host = False
        self.units = 0
        self.window_s = 0.0
        self.spans = {}
        self.counters = {}
        self.events = []
        self.host_events = []
        self.extract_s = 0.0

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.host

    def begin(self, host: bool = False) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CUDA] if cuda else []
        if host or not cuda:
            acts.append(ProfilerActivity.CPU)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.host = host
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def end(self, units: int = 0) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._t0
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        events = _events(self.prof)
        self.extract_s += time.perf_counter() - t
        if self.host:
            self.host_events = events
        else:
            self.events, self.units, self.window_s = events, units, wall
        self.prof = None

    def span(self, name: str, seconds: float) -> None:
        if self.active:
            self.spans.setdefault(name, []).append(seconds)


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader gets: the profiled units' events,
    the harness's spans and the program's counters over them."""

    units: int
    window_s: float
    events: list
    spans: dict
    counters: dict
    kernels: dict

    def device_events(self):
        return [e for e in self.events if e.device]

    def is_port(self, e) -> bool:
        ident = kernel_ident(e.name)
        return any(ident in names for names in self.kernels.values())


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    gaps summed by the innermost host operation running at each gap's
    middle ("(host outside any op)" where none was: Python between
    operations). CUDA runtime calls are not taken as labels."""
    import heapq

    by_name = {}
    for e in events:
        if e.device:
            key = e.name[:160]
            by_name[key] = by_name.get(key, 0.0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, spans = device_busy(events)
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(spans, spans[1:]))
    host = sorted((e.start, e.end, e.name) for e in events
                  if not e.device and not e.name.startswith("cuda"))
    by_host, heap, i = {}, [], 0
    for mid, length in gaps:
        while i < len(host) and host[i][0] <= mid:
            s, t, name = host[i]
            heapq.heappush(heap, (t - s, t, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        # the innermost open op is the shortest one not ended: every
        # shorter op that started before the gap has ended and was popped
        label = heap[0][2][:160] if heap else "(host outside any op)"
        by_host[label] = by_host.get(label, 0.0) + length
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


# ---------------------------------------------------------------- a run

def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda:0",
             t_start: float | None = None, bench: dict | None = None,
             here: Path = HERE) -> dict:
    """Run cell `name` once and return its result line (a dict). Raises
    if a forbidden module was loaded."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, bench, here)
    print(card_line(device), file=sys.stderr, flush=True)
    print(f"cell {name}: config {cell.entry['config']} {json.dumps(_settings(cell.config))}, "
          f"traffic {cell.entry['traffic']} {json.dumps(cell.traffic)}, seed {seed}, "
          f"seconds {seconds}, trace {int(trace)}, torch {torch.__version__}", file=sys.stderr,
          flush=True)
    kernels = port_kernels()
    drv = cell.driver.Driver(cell, seed, device)
    drv.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s", file=sys.stderr, flush=True)

    tracer = Tracer(device) if trace else None
    drv.window(seconds, tracer)
    peak = 0
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    print(card_line(device), file=sys.stderr, flush=True)
    for line in drv.summary():
        print(line, file=sys.stderr, flush=True)

    metrics, extra = {}, {}
    if trace:
        ctx = TraceContext(tracer.units, tracer.window_s, tracer.events, tracer.spans,
                           tracer.counters, kernels)
        busy, _ = device_busy(tracer.events)
        for m in cell.per_layer:
            reader = load_module(here / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        extra = {"busy_s": busy, "window_s": tracer.window_s}
        print(f"traced {tracer.units} units in {tracer.window_s:.3f} s, {len(tracer.events)} "
              f"events, read in {tracer.extract_s:.1f} s", file=sys.stderr, flush=True)
    else:
        values = drv.end_to_end()
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    t = time.perf_counter()
    drv.free()
    correct, checks = compare.judge(drv.judge(), cell.checks["limits"])
    print(f"comparison in {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")
    dev = torch.device(device)
    result = {
        "correct": bool(correct),
        "attempted": int(drv.attempted),
        "failed": int(drv.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": int(cell.entry["chips"]),
            "memory_peak_bytes": peak,
            **extra,
        },
    }
    if trace:
        result["breakdown"] = breakdown(tracer.host_events or tracer.events)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    result["checks"] = checks
    return result


def _settings(config: dict) -> dict:
    return {k: v for k, v in config.items()
            if k not in ("scene", "source", "why_reduced", "assumed")}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
