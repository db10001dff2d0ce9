"""pyrenderer_tpu_torch.utils.profiling against pyrenderer_tpu.utils.profiling
on the CPU: RenderStats bit for bit, device_sync's value, slope_time's
arithmetic under an injected clock, trace_profile's trace and its refusal
to hide a failing profiler, device_busy on a recorded event list; and the
harnesses' shared device rule (perf/harness.py)."""

import dataclasses
import importlib
import inspect
import json
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from pyrenderer_tpu.utils import profiling as prof_jax
from pyrenderer_tpu_torch.kernels import intersect as ki
from pyrenderer_tpu_torch.perf import clusterbench, harness
from pyrenderer_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)

HARNESSES = ("estbench", "microbench", "ablate", "glue2", "binnedglue", "binnedgran")


@pytest.mark.parametrize("adds", [
    [],
    [(1.5e6, 1, 4096, 0.25)],
    [(3.0e6, 2, 4096, 0.5), (7.25e5, 1, 1024, 0.125), (1e9, 16, 1 << 20, 3.0)],
])
def test_render_stats_matches_jax(adds):
    """Every field, both rates and summary() equal to the JAX class's."""
    a, b = prof.RenderStats(), prof_jax.RenderStats()
    for args in adds:
        a.add(*args)
        b.add(*args)
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    assert (a.rays, a.samples, a.pixels, a.seconds) == (b.rays, b.samples, b.pixels, b.seconds)
    assert a.mrays_per_sec == b.mrays_per_sec and a.samples_per_sec == b.samples_per_sec
    assert a.summary() == b.summary()


def test_device_sync_returns_the_sum_as_jax():
    # small integers: their float32 sum is exact in any order of the adds
    x = np.arange(-96, 96, dtype=np.float32).reshape(64, 3) * np.float32(0.5)
    assert prof.device_sync(torch.from_numpy(x)) == prof_jax.device_sync(jnp.asarray(x))
    assert prof.device_sync((torch.from_numpy(x), 3)) == prof.device_sync(torch.from_numpy(x))
    assert prof.device_sync({"a": torch.ones(4)}) == 4.0
    assert prof.device_sync() is None and prof.device_sync(device="cpu") is None


class _Clock:
    """A host clock that moves only when told: each stage call adds `per_call`
    seconds, and the k-th timing's end adds `overheads[k]` (its fixed cost:
    syncs, the clock)."""

    def __init__(self, per_call, overheads):
        self.t, self.per_call, self.overheads, self.reads = 0.0, per_call, list(overheads), 0

    def __call__(self):
        if self.reads % 2 == 1:
            self.t += self.overheads.pop(0)
        self.reads += 1
        return self.t

    def stage(self, x):
        self.t += self.per_call
        return x * 2


def test_slope_time_arithmetic_is_exact():
    """eager ms is the slope between the minima over the reps of the two
    counts of calls: fixed costs cancel, the slowest reps do not count."""
    clock = _Clock(0.25, [1.0, 3.0, 2.0, 1.0, 5.0, 1.0])
    st = prof.slope_time(clock.stage, torch.ones(4), inner=(4, 16), reps=3, clock=clock)
    # minima: 4 calls -> 1.0 + 4 * 0.25 = 2.0; 16 calls -> 1.0 + 16 * 0.25 = 5.0
    assert st.eager_ms == 250.0
    assert st.graph_ms is None and st.busy_ms is None and st.device_events is None
    assert st.host_syncs is None and st.launches == {} and st.twin_calls == {}
    assert torch.equal(st.out, torch.full((4,), 2.0))
    clock = _Clock(0.5, [0.0] * 4)
    assert prof.slope_time(clock.stage, torch.ones(1), inner=(2, 8), reps=2,
                           clock=clock).eager_ms == 500.0


def test_slope_time_counts_one_calls_launches_and_twins():
    """On CPU tensors a kernel wrapper runs its twin: one call of the stage
    counts one twin call of each wrapper it reaches and no launch."""
    from pyrenderer_tpu_torch.perf import estbench

    x = estbench.inputs("cpu", 64)
    st = prof.slope_time(estbench.kernel_pair, x.tables.tri_table, x.cfg, x.ro, x.rd,
                         inner=(1, 2), reps=1)
    assert st.launches == {} and st.twin_calls == {"closest_hit": 1, "occluded": 1}
    hit, t, _ = ki.closest_hit(x.tables.tri_table, x.ro, x.rd, x.cfg.t_min, x.cfg.t_max)
    assert torch.equal(st.out, t + ki.occluded(x.tables.tri_table, x.ro, x.rd, x.cfg.t_min,
                                               1.0).float())


def test_device_timer_reads_the_clock_around_the_block():
    ticks = iter([10.0, 10.75])
    with prof.DeviceTimer(torch.ones(3), clock=lambda: next(ticks)) as timer:
        pass
    assert timer.seconds == 0.75
    with prof.DeviceTimer(device="cpu") as timer:
        timer.payload = torch.ones(2)
    assert timer.seconds >= 0.0


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    with prof.trace_profile(str(tmp_path / "trace")) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert len(p.events()) > 0
    with prof.trace_profile(None) as p:
        assert p is None
    with prof.trace_profile("") as p:
        assert p is None


def test_trace_profile_raises_where_the_profiler_fails(tmp_path, monkeypatch):
    """The deliberate difference from the JAX function, which runs the block
    unprofiled when the profiler raises."""
    def broken(*args, **kwargs):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with pytest.raises(RuntimeError, match="no profiler"):
        with prof.trace_profile(str(tmp_path)):
            ran.append(1)
    assert ran == []


def _event(start, end, name, device=True):
    return types.SimpleNamespace(time_range=types.SimpleNamespace(start=start, end=end),
                                 name=name, device_type=DeviceType.CUDA if device
                                 else DeviceType.CPU)


def test_device_busy_on_a_recorded_event_list():
    """The union of the device intervals, the time by kernel name and the
    device events counted, host events ignored: the numbers clusterbench
    profile prints (its cmd_profile reads them from this function)."""
    events = [
        _event(0.0, 10.0, "k1"), _event(5.0, 12.0, "k2"), _event(20.0, 25.0, "k1"),
        _event(21.0, 22.0, "memcpy"), _event(30.0, 30.5, "k3"),
        _event(0.0, 100.0, "cudaLaunchKernel", device=False),
    ]
    busy, per_name, n = prof.device_busy(events)
    assert busy == 12.0 + 5.0 + 0.5
    assert per_name == {"k1": 15.0, "k2": 7.0, "memcpy": 1.0, "k3": 0.5}
    assert n == 5
    assert prof.device_busy([]) == (0.0, {}, 0)
    src = inspect.getsource(clusterbench.cmd_profile)
    assert "device_busy(" in src and "trace_profile(" in src
    assert not hasattr(clusterbench, "device_busy")


def test_read_profile_keeps_only_complete_profiles():
    """busy ms, device events and host syncs of one call, the sentinel kernel
    left out; "not measured" when a launch of the port's kernels has no
    record (a record lost by the profiler)."""
    events = [
        _event(0.0, 4.0, "void (anonymous namespace)::closest_kernel<8>(float const*)"),
        _event(5.0, 6.0, "void (anonymous namespace)::elementwise_kernel_with_index<int>"),
        _event(2.0, 3.0, "cudaStreamSynchronize", device=False),
        _event(9.0, 19.0, "at::cuda::(anonymous namespace)::spin_kernel(long)"),
    ]
    assert prof.read_profile(events, 1) == (5.0 / 1e3, 2, 1)
    assert prof.read_profile(events, 2) == (None, None, None)
    assert prof.read_profile(events[1:], 1) == (None, None, None)
    assert prof.read_profile(events[1:], 0) == (1.0 / 1e3, 1, 1)


def _global_functions():
    """The __global__ functions of csrc/*.cu, by name."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    csrc = os.path.join(os.path.dirname(prof.__file__), "..", "csrc")
    return sorted({m for f in sorted(os.listdir(csrc)) if f.endswith(".cu")
                   for m in pat.findall(open(os.path.join(csrc, f)).read())})


@pytest.mark.parametrize("name", _global_functions())
def test_port_kernel_names_every_global_function(name):
    """read_profile counts a record of every kernel of csrc/*.cu (the
    Threefry kernel of csrc/rng.cu among them) as one of the port's
    launches, as the profiler names it, templated or not."""
    assert prof.PORT_KERNEL.match(f"void (anonymous namespace)::{name}<8>(float const*)")
    assert prof.PORT_KERNEL.match(f"(anonymous namespace)::{name}(long, int)")
    assert not prof.PORT_KERNEL.match(f"at::native::{name}(long)")


@pytest.mark.parametrize("name", HARNESSES)
def test_harness_without_gpu_exits_2(name, capsys, monkeypatch):
    """Without a CUDA device and without --device cpu, each harness exits 2
    with a message and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"pyrenderer_tpu_torch.perf.{name}")
    assert mod.main(["--n", "16"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_harness_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.device_of("cpu") == torch.device("cpu")
    assert harness.device_of("cuda:0") is None
    assert harness.card("cpu") == "cpu"


def test_no_profile_flag(capsys):
    """--no-profile is accepted by the profiled harnesses (their rows then
    carry no profiler column) and not offered by binnedgran, whose children
    never profile."""
    from pyrenderer_tpu_torch.perf import ablate

    assert ablate.main(["--device", "cpu", "--n", "64", "--reps", "1", "--no-profile"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rows"]
    assert all(r["busy_ms"] is None and r["device_events"] is None for r in rows)
    assert "--no-profile" in harness.parser("x", 1).format_help()
    assert "--no-profile" not in harness.parser("x", 1, profile=False).format_help()
