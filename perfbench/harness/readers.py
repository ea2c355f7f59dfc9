"""What the metric readers under metrics/ compute, from a run record.

A reader returns None where the run holds nothing to read (no trace, no
frames, no range for the kernel), and the harness leaves the metric out;
it never returns 0 for a share.
"""

from harness.common import percentile


def frames_per_s(run):
    """All frames of all videos completed in the window over its time."""
    if run.get("kind") != "serve" or not run["frames"]:
        return None
    return run["frames"] / run["window_s"]


def latency_percentile_s(run, q):
    """The q-th percentile of every video's latency in the window."""
    if run.get("kind") != "serve" or not run["latencies"]:
        return None
    return percentile(run["latencies"], q)


def stage_ms_per_frame(run, stage):
    """A stage's summed milliseconds (the program's StageTimer) over the
    traced videos, per frame completed."""
    stages = run.get("stages_ms") or {}
    if stage not in stages or not run["frames"]:
        return None
    return stages[stage] / run["frames"]


def roofline_pct(run, kernel):
    """The least time the card needs for the kernel's counted work
    (operations at the dtype's peak against bytes at HBM bandwidth) over
    the device time of every kernel launched inside its profiler range."""
    tr = run.get("trace")
    if not tr:
        return None
    device_s = tr["range_s"].get(f"perfbench.{kernel}")
    w = run["work"]
    if not device_s or not w[f"{kernel}_flops"]:
        return None
    bound = max(w[f"{kernel}_flops"] / run["peak_flops"],
                w[f"{kernel}_bytes"] / run["peak_bytes_per_s"])
    return 100.0 * bound / device_s


def mfu_pct(run):
    """Model FLOPs of the traced videos over the traced window's time, as
    a share of the dtype's peak."""
    if run.get("kind") != "serve" or not run.get("trace") \
            or not run["frames"]:
        return None
    return 100.0 * run["work"]["model_flops"] / (run["peak_flops"]
                                                 * run["window_s"])


def idle_pct(run):
    """Share of the traced window with no kernel, copy or set on the
    device (the union of the profiler's device intervals)."""
    tr = run.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gib(run):
    """max_memory_allocated over the window, after a reset at its start."""
    if not run["peak_bytes"]:
        return None
    return run["peak_bytes"] / 2 ** 30
