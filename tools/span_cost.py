#!/usr/bin/env python3
"""What recording a serving call costs, on the card, cell by cell:

    python3 tools/span_cost.py [--cells base_bf16_davis ...] [--seed N]
                               [--passes 3]

For each benchmark cell (`perfbench/`, found by name in BENCHMARK.json)
it builds the cell's program and video pool from the seed as a run of
the benchmark does, runs the pool once as set-up, then times whole
passes over the pool in turns with no timer and with a
utils.timing.StageTimer attached (no profiler), `--passes` of each:
frames/s a pass. It also times, on the host clock, what the harness's
loop does around each call: the `masks.astype(np.float32)` of its
Program.__call__, and the rest of a pass outside the calls. One JSON
line a pass, with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

from harness import common  # noqa: E402


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def one_pass(program, videos, timed):
    """frames/s of one pass over the pool, the seconds of its calls, and
    the seconds of the masks' cast the harness makes before each."""
    import torch
    frames = calls = cast = 0.0
    t0 = time.perf_counter()
    for video, masks in videos:
        timer = program.stage_timer() if timed else None
        c0 = time.perf_counter()
        m32 = masks.astype(np.float32)
        c1 = time.perf_counter()
        program.inpainter(video, m32, video, masks, timer=timer)
        c2 = time.perf_counter()
        if timer is not None:
            timer.totals()
        cast += c1 - c0
        calls += c2 - c1
        frames += len(video)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"frames_per_s": frames / wall, "wall_s": wall, "calls_s": calls,
            "masks_cast_s": cast, "loop_rest_s": wall - calls - cast}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", nargs="+", default=[
        "base_bf16_davis", "hq_bf16_davis480", "base_f32_davis"])
    p.add_argument("--seed", type=int, default=2 ** 31 + 12345)
    p.add_argument("--passes", type=int, default=3)
    args = p.parse_args(argv)
    common.cache_dirs()
    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    serve = common.traffic_kind("serve_videos")
    name = card()
    for cell_name in args.cells:
        cell = common.cell(cell_name)
        videos = serve.make_videos(cell["traffic"], args.seed, dev)
        program = serve.Program(cell, args.seed, dev)
        one_pass(program, videos, False)
        for i in range(args.passes):
            order = (False, True) if i % 2 == 0 else (True, False)
            for timed in order:
                rec = one_pass(program, videos, timed)
                print(json.dumps({"cell": cell_name, "pass": i,
                                  "timer": timed, "card": name, **rec}),
                      flush=True)
        del program
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
