#!/usr/bin/env python3
"""The benchmark of e2fgvi_tpu_torch, one run of one cell:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is found by name in BENCHMARK.json
(its config, traffic mix and limits are files under perfbench/). The run
makes its weights and inputs from the seed, warms up, measures for
`seconds` (--trace 1: a fixed number of requests under the profiler), then
compares what the timed path produced with the plain reference, and prints
one JSON line last on stdout: correct, attempted, failed, metrics
(--trace 0 the cell's end-to-end metrics, --trace 1 its per-layer ones),
device, breakdown (traced), and `compared`, the numbers compared with
their limits, which also end stderr.

It needs CUDA and the cards the cell asks for, and exits nonzero with no
result otherwise, or when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

import argparse
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import common  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def execute(cell, seed, seconds, traced, device, clock, bench=None,
            program_cls=None):
    """Run the cell and build the result object (before the JAX guard)."""
    import torch
    kind = common.traffic_kind(cell["traffic"]["kind"])
    kwargs = {} if program_cls is None else {"program_cls": program_cls}
    rec = kind.run(cell, seed % 2 ** 64, seconds, traced, device, clock,
                   **kwargs)
    metrics = {}
    for name, unit in common.metrics_for(cell["name"], traced, bench):
        value = common.reader(name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if traced and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["compared"] = rec["compared"]
    return out, rec


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None):
    clock = common.Clock()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    common.cache_dirs()
    import torch
    torch.set_num_threads(4)
    bench = common.benchmark()
    cell = common.cell(args.workload, bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.device_count()}")
        return 2
    log(f"card: {power_limit()}")
    out, rec = execute(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda:0"), clock, bench)
    banned = common.banned_modules()
    if banned:
        log(f"modules of JAX or the JAX package are loaded: {banned}")
        return 3
    log(f"checked videos of lengths {rec['checked_lengths']}")
    log("compared: " + common.compared_text(out["compared"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
