"""The reader of the program's conv_launches counter (launches of C1, the
float32 3x3 convolution kernel) on run records: its value per video, None
where the program returned no such entry (a parent without it, or the
CPU), and a count of 0 (a bfloat16 cell's videos) read as 0."""

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


TRACED = {"encode": 900.0, "host_syncs": 58,
          "conv_launches": 1860, "conv_launches.feat_prop": 1860}

SUFFIXES = ["", ".hq", ".f32"]


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_reader_reads_launches_per_video(suffix):
    read = common.reader("conv_launches_per_video" + suffix).read
    assert read(run_record(TRACED)) == pytest.approx(465.0)


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_no_conv_launches_read_zero(suffix):
    read = common.reader("conv_launches_per_video" + suffix).read
    assert read(run_record(dict(TRACED, conv_launches=0))) == 0


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_a_program_without_the_counter_reads_none(suffix):
    read = common.reader("conv_launches_per_video" + suffix).read
    stages = {k: v for k, v in TRACED.items() if "conv_launches" not in k}
    assert read(run_record(stages)) is None
    assert read(run_record(TRACED, videos=0)) is None
    assert read({"kind": "serve", "frames": 0, "latencies": []}) is None
