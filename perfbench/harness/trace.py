"""The device timeline of a traced window, from torch.profiler's trace.

Busy time is the union of the device's kernel, copy and set intervals
inside the window, so overlapping work counts once. A range that the
harness opens with `torch.profiler.record_function` is given the device
time of every kernel launched inside it: the runtime calls on the range's
thread between its start and end, matched to their kernels by the
profiler's correlation ids.
"""

import bisect
import contextlib
import heapq
import json
import os
import sys
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "perfbench.window"
TOP = 10
NAME_CHARS = 120


@contextlib.contextmanager
def profile():
    """Profile the body on the CPU and CUDA; yields a list that is filled
    with the trace's complete events when the body ends. The trace file
    goes to TMPDIR and is removed once read."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    events = []
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        yield events
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        t1 = time.perf_counter()
        with open(path) as f:
            data = json.load(f)
        print(f"trace: {os.path.getsize(path) / 2 ** 20:.0f} MiB written "
              f"in {t1 - t0:.1f} s, read in {time.perf_counter() - t1:.1f}"
              " s", file=sys.stderr, flush=True)
    finally:
        os.remove(path)
    events.extend(e for e in data.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e)


def union(intervals):
    """Total length covered by [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _clip(s, e, lo, hi):
    return max(s, lo), min(e, hi)


def summarize(events, ranges=()):
    """{busy_s, window_s, range_s: {name: device s}, device_ops, idle_gaps}
    of the window the `perfbench.window` annotation spans."""
    wins = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == WINDOW]
    if len(wins) != 1:
        raise RuntimeError(f"{len(wins)} '{WINDOW}' ranges in the trace")
    lo, hi = float(wins[0]["ts"]), float(wins[0]["ts"]) + float(wins[0]["dur"])
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            s, t = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         lo, hi)
            if t > s:
                device.append((s, t, e))
    if not device:
        raise RuntimeError("the trace holds no device operation in the "
                           "window")
    busy = union([(s, t) for s, t, _ in device])

    by_name = {}
    for s, t, e in device:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    range_s = {r: _range_device_s(events, r) for r in ranges}
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "range_s": range_s, "device_ops": [list(x) for x in device_ops],
            "idle_gaps": _idle_gaps(events, device, lo, hi, wins[0])}


def _range_device_s(events, name):
    """Device seconds of the kernels launched inside every `name` range;
    None where the trace holds no such range."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == name]
    if not spans:
        return None
    launches = sorted(((float(e["ts"]), e.get("tid"),
                        e.get("args", {}).get("correlation"))
                       for e in events if e.get("cat") in LAUNCH_CATS),
                      key=lambda x: x[0])
    starts = [x[0] for x in launches]
    corr = set()
    for sp in spans:
        a, b = float(sp["ts"]), float(sp["ts"]) + float(sp["dur"])
        for ts, tid, c in launches[bisect.bisect_left(starts, a):
                                   bisect.bisect_right(starts, b)]:
            if tid == sp.get("tid") and c is not None:
                corr.add(c)
    return sum(float(e["dur"]) for e in events
               if e.get("cat") in DEVICE_CATS
               and e.get("args", {}).get("correlation") in corr) / 1e6


def _idle_gaps(events, device, lo, hi, window):
    """The window's idle device time by what the host was doing: each gap
    between busy intervals is named by the shortest host operation or
    harness range on the window's thread that covers its middle."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATS
                  and e.get("tid") == window.get("tid")
                  and e["name"] != WINDOW)
    gaps, end = [], lo
    for s, t, _ in sorted(device, key=lambda x: x[0]):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if hi > end:
        gaps.append((end, hi))
    named, j, active = {}, 0, []        # active: (duration, end, name)
    for a, b in gaps:                   # in time order
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            hs, he, hn = host[j]
            heapq.heappush(active, (he - hs, he, hn))
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2][:NAME_CHARS] if active else \
            "host outside torch ops"
        named[name] = named.get(name, 0.0) + (b - a) / 1e6
    return [list(x) for x in sorted(named.items(),
                                    key=lambda kv: -kv[1])[:TOP]]
