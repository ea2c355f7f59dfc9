#!/usr/bin/env python3
"""Readings for the limits of a serving cell: on each seed, the numbers
that the run compares, for the program (sound runs: the lower readings)
and for the control (the plain reference in the program's place, in the
precision below the cell's: the upper readings), on the videos a run
checks. One process for all seeds, so set-up is paid once.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3

Prints one JSON line a seed. The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import check, common  # noqa: E402


def readings(cell, seed, device, control, program):
    """{program: [worst_frame_mae, outside], control: [...]} on one seed."""
    import numpy as np
    import torch
    kind = common.traffic_kind(cell["traffic"]["kind"])
    cfg, tr = cell["config"], cell["traffic"]
    plan = kind.pool(tr, seed)
    videos = kind.make_videos(tr, seed, device)
    sample = kind.check_sample(plan, range(len(plan)), seed,
                               tr["check_videos"])
    got = {}
    if program:
        prog = kind.Program(cell, seed, device)
        got["program"] = [np.stack(prog(*videos[k])) for k in sample]
        del prog
        torch.cuda.empty_cache() if device.type == "cuda" else None
    g = check.reference_generator(cfg["variant"], seed, device)
    if control:
        got["control"] = [check.reference_video(
            g, cfg, tr, videos[k], device, cell["check"]["control"])
            for k in sample]
    want = [check.reference_video(g, cfg, tr, videos[k], device)
            for k in sample]
    out = {"seed": seed, "lengths": [plan[k][0] for k in sample]}
    for name, outs in got.items():
        r = [check.compare(o, w, videos[k][1])
             for o, w, k in zip(outs, want, sample)]
        out[name] = [max(x[0] for x in r), max(x[1] for x in r)]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    common.cache_dirs()
    import torch
    torch.set_num_threads(4)
    cell = common.cell(args.workload)
    device = torch.device("cuda:0")
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, device, control=True, program=True)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
