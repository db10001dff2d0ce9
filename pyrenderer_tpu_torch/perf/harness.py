"""What the stage-breakdown harnesses share: their command line, the device
rule, one printed line per stage and the JSON line that ends a run.

The harnesses (estbench, microbench, ablate, glue2, binnedglue and
binnedgran in this package) time stages with utils/profiling.slope_time.
Each runs on the card unless it is asked for the CPU (``--device cpu``, the
rule of pyrenderer_tpu_torch/bench.py): without a CUDA device and without
that flag it exits 2 with a message. Each row prints the eager ms, the graph
ms where the stage was captured (else "-"), the device's busy ms, ns per
item (eager), and of one call under torch.profiler its device events and
the host's waits for the device, then the port's kernel launches of one
call; the run ends with one JSON line holding the card's name and power
limit, every row and the launches of the whole run.

Run each harness in a process of its own for those profiler columns: in a
process that had already run many profiled windows, CUDA graphs and
kernels (chip_smoke.py's, on an H100 with torch 2.11), torch.profiler
dropped device records, so a row's busy ms and events came out short.
slope_time reports "not measured" where it can tell (a launch of the
port's kernels without its record); ``--no-profile`` skips the profiler
(chip_smoke.py runs the harnesses in its own process so).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def parser(description: str, n_default: int, profile: bool = True) -> argparse.ArgumentParser:
    """The harnesses' common flags; `profile` adds --no-profile (the harnesses
    whose rows are profiled)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda:0",
                   help="cuda:K (default cuda:0) or cpu (the plain twins, for tests)")
    p.add_argument("--n", type=int, default=n_default, help=f"rays (default {n_default})")
    p.add_argument("--reps", type=int, default=5,
                   help="timings per count of calls; the minimum is kept (default 5)")
    if profile:
        p.add_argument("--no-profile", action="store_true",
                       help="no torch.profiler call per row (busy ms, events and syncs "
                            "print as -): for runs inside a long-lived process")
    return p


def device_of(name: str):
    """The torch.device `name` asks for, or None when it asks for a CUDA
    device this machine does not have."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        return None
    return device


NO_GPU = "no CUDA device: the harness runs on a GPU (--device cpu runs it on the CPU, for tests)"


def card(device) -> str:
    """The card's name and power limit as nvidia-smi prints them
    (perf/clusterbench.card_line), "cpu" for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from pyrenderer_tpu_torch.perf.clusterbench import card_line

    return card_line()


class Report:
    """The rows of one harness run, printed as they come."""

    def __init__(self, harness: str, device, n: int, **meta):
        self.harness = harness
        self.device = torch.device(device)
        self.card = card(self.device)
        self.n = n
        self.meta = meta
        self.rows = []
        print(f"{harness}: device {self.device} ({self.card}), N={n}"
              + "".join(f", {k}={v}" for k, v in meta.items()), flush=True)
        print(f"{'stage':20s} {'eager ms':>10s} {'graph ms':>10s} {'busy ms':>10s} "
              f"{'ns/item':>8s} {'events':>7s} {'syncs':>6s}  launches", flush=True)

    def row(self, name: str, st, items: int | None = None, note: str = "", **extra):
        """Add one stage's StageTime; ns/item is eager ms over `items`
        (default N). Returns the row's dict."""
        items = self.n if items is None else items
        row = {"name": name, "eager_ms": st.eager_ms, "graph_ms": st.graph_ms,
               "busy_ms": st.busy_ms, "ns_per_item": st.eager_ms * 1e6 / items,
               "items": items, "launches": st.launches, "twin_calls": st.twin_calls,
               "device_events": st.device_events, "host_syncs": st.host_syncs, **extra}
        if note:
            row["note"] = note
        self.rows.append(row)
        graph = "-" if st.graph_ms is None else f"{st.graph_ms:.4f}"
        busy = "-" if st.busy_ms is None else f"{st.busy_ms:.4f}"
        events = "-" if st.device_events is None else str(st.device_events)
        syncs = "-" if st.host_syncs is None else str(st.host_syncs)
        print(f"{name:20s} {st.eager_ms:10.4f} {graph:>10s} {busy:>10s} "
              f"{row['ns_per_item']:8.2f} {events:>7s} {syncs:>6s}  {st.launches or {}}"
              + "".join(f"  {k}={v}" for k, v in extra.items()) + (f"  ({note})" if note else ""),
              flush=True)
        return row

    def result(self) -> dict:
        """The run's JSON object: its rows, and the launches and twin calls
        of every kernel wrapper in this process so far (the whole run, when
        the harness runs in a process of its own)."""
        from pyrenderer_tpu_torch import kernels

        launches, twins = kernels.counts()
        return {"harness": self.harness, "device": str(self.device), "card": self.card,
                "n": self.n, **self.meta, "rows": self.rows, "launches_total": launches,
                "twin_calls_total": twins}


def main(run, args) -> int:
    """The harness's entry: exit 2 without the device `args.device` asks
    for; otherwise run(device, args), then its result as the JSON line."""
    device = device_of(args.device)
    if device is None:
        print(NO_GPU, file=sys.stderr)
        return 2
    print(json.dumps(run(device, args)), flush=True)
    return 0
