"""90th percentile of per-video latency (host clock, from the call to the
returned frames) over all videos of the window."""

from harness.readers import latency_percentile_s


def read(run):
    return latency_percentile_s(run, 90)
