"""Where a region's time goes, operation by operation.

Counterpart of e2fgvi_tpu/utils/profiling.py. Its `time_stage` is
`utils/timing.cuda_ms` here: CUDA events need no fencing. Its `trace`
becomes a torch.profiler context over CPU and CUDA activities that hands
back the operations that took most time on the traced device. Unlike the
JAX package's trace it never degrades to a no-op: a profiler that cannot
start, or a trace that recorded nothing on its device, raises.
"""

import contextlib
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from e2fgvi_tpu_torch.utils import env

TOP = 10


@contextlib.contextmanager
def trace(log_dir=None, device=None):
    """Profile the body on `device` (None: CUDA, which must be there).

    Yields a dict that is filled when the body ends: `device`; `wall_ms`,
    the host clock around the body between two synchronizations;
    `busy_ms`, the self time of every operation on the device summed
    (kernels on CUDA, aten operations on the CPU); `top`, the TOP
    operations by that time, each {"name", "calls", "ms"}, largest first;
    and `chrome_trace`, the path of the trace written under `log_dir`
    where one is given."""
    dev = env.device(device)
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    result = {"device": str(dev)}
    with torch.profiler.profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        yield result
        sync()
        result["wall_ms"] = (time.perf_counter() - t0) * 1e3
    kind = DeviceType.CUDA if cuda else DeviceType.CPU

    def self_us(e):
        return e.self_device_time_total if cuda else e.self_cpu_time_total

    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == kind and self_us(e) > 0),
                  key=self_us, reverse=True)
    if not rows:
        raise RuntimeError(f"torch.profiler recorded no time on {dev}")
    result["busy_ms"] = sum(self_us(e) for e in rows) / 1e3
    result["top"] = [{"name": e.key, "calls": e.count,
                      "ms": self_us(e) / 1e3} for e in rows[:TOP]]
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        result["chrome_trace"] = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(result["chrome_trace"])
