"""What every run shares: finding a cell's files by name, the metric
readers, the guard against JAX, statistics, and the result line.

A cell is found by its name in BENCHMARK.json: its entry names a config
(`configs/<config>.json`) and a traffic mix (`traffic/<traffic>.json`,
whose `kind` names the generator `traffic/<kind>.py`), and
`workloads/<name>.json` holds the cell's correctness limits. A metric is
read by `metrics/<name>.py`'s `read(run)`; where no such file exists, by
the reader of its family, the name without its last dotted part (a
cell's `frames_per_s.hq` by `metrics/frames_per_s.py`). New cells, mixes
and metrics are new files and new entries; no file here names one.
"""

import importlib.util
import json
import math
import os
import re
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# top-level module names no run may hold, compared whole
BANNED = ("jax", "jaxlib", "flax", "e2fgvi_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name, bench=None):
    """The cell's merged description: its BENCHMARK.json entry, its
    workload file, its config and its traffic mix."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    entry = entries[0]
    spec = load_json(os.path.join(BENCH, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} {spec[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    cfg_entry = [c for c in bench["configs"] if c["name"] == entry["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry[0]["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic",
                                     f"{entry['traffic']}.json"))
    return {"name": name, "chips": entry["chips"], "config": config,
            "traffic": traffic, "check": spec["check"]}


def metrics_for(name, trace, bench=None):
    """[(metric name, unit)] that the cell reports: with trace the
    per-layer metrics, else the end-to-end ones; a metric with a
    `workloads` list only in those cells."""
    bench = bench or benchmark()
    group = bench["per_layer" if trace else "end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if name in m.get("workloads", [name])]


def _load_file(path, modname):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric):
    """metrics/<metric>.py, or its family's reader, loaded by path
    (metric names hold dots)."""
    name = metric
    while not os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py")):
        if "." not in name:
            raise FileNotFoundError(f"no reader for metric {metric!r}")
        name = name.rsplit(".", 1)[0]
    modname = "perfbench_metric_" + re.sub(r"\W", "_", name)
    return _load_file(os.path.join(BENCH, "metrics", f"{name}.py"),
                      modname)


def traffic_kind(kind):
    return _load_file(os.path.join(BENCH, "traffic", f"{kind}.py"),
                      "perfbench_traffic_" + kind)


def banned_modules(modules=None):
    mods = sys.modules if modules is None else modules
    return sorted(n for n in mods if n.split(".")[0] in BANNED)


def percentile(values, q):
    """The q-th percentile (0-100) of all values, linear between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def process_age_s():
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """Host seconds since the process started."""

    def __init__(self):
        self.t0 = time.perf_counter() - process_age_s()

    def __call__(self):
        return time.perf_counter() - self.t0


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's nvcc library goes to build/ by itself."""
    base = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv")


def compared_text(compared):
    """'name value (limit L), ...' of the numbers compared."""
    return ", ".join(f"{k} {v['value']!r} (limit {v['limit']!r})"
                     for k, v in compared.items())
