"""The readers of the program's own spans and counters (the prep and fetch
spans, host_syncs, device_alloc_calls) on run records: their values, None
where the program returned no such entry (a parent without it, or the
CPU), and a count of 0 read as 0."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

from harness import common  # noqa: E402


def run_record(stages, videos=4, frames=200):
    return {"kind": "serve", "frames": frames,
            "latencies": [0.5] * videos, "stages_ms": stages}


TRACED = {"encode": 900.0, "prep": 600.0, "blend": 30.0, "fetch": 50.0,
          "host_syncs": 58, "host_syncs.prep": 8,
          "device_alloc_calls": 6, "device_alloc_calls.feat_prop": 6}


@pytest.mark.parametrize("suffix", ["", ".hq", ".f32"])
@pytest.mark.parametrize("metric, want", [
    ("stage_ms_per_frame.prep", 3.0),
    ("stage_ms_per_frame.fetch", 0.25),
    ("host_syncs_per_video", 14.5),
    ("device_alloc_calls_per_video", 1.5)])
def test_readers_read_the_program_entries(metric, want, suffix):
    read = common.reader(metric + suffix).read
    assert read(run_record(TRACED)) == pytest.approx(want)
    parent = {k: v for k, v in TRACED.items()
              if k in ("encode", "blend")}
    assert read(run_record(parent)) is None
    assert read(run_record(None)) is None


def test_a_count_of_zero_reads_zero():
    read = common.reader("device_alloc_calls_per_video").read
    assert read(run_record(dict(TRACED, device_alloc_calls=0))) == 0
    assert read(run_record(TRACED, videos=0)) is None
