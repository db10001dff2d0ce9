"""The control of a cell's comparison, and its planted faults: the plain
reference with a variant, put in the program's place and judged as a
run's output is.

    python3 benchmark/control.py --workload cornell.render --samples 71 --seeds 1 2 3
    python3 benchmark/control.py --workload cornell.train --variant half_batch --seeds 1 2 3

The variant "bfloat16" (the default) computes the reference one precision
below the configuration's float32; the cell's driver module may know
others (drivers/train.py: "half_batch", "altered"). A render cell's run
sums `--samples` samples of each compared pixel (the sample count of a
run's film). For each seed it prints the comparison's numbers beside the
cell's limits: a limit that the control or a fault does not exceed
separates nothing. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--variant", default="bfloat16")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = cell.driver.control_numbers(cell, seed, "cuda:0", args.variant,
                                              samples=args.samples)
        print(json.dumps({"workload": args.workload, "seed": seed, "samples": args.samples,
                          "variant": args.variant, "numbers": numbers, "limits": cell.checks["limits"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
