#!/usr/bin/env python3
"""Readings for the limits of the propainter cell: on each seed, on the
videos a run checks, the numbers that the run compares for the program
(sound runs: the lower readings) and for the two controls (the upper
readings): the plain reference with the generator's products in fp8
(`check.control`, held to worst_frame_mae) and the reference's RAFT in
TF32 (`check.flow_control`, held to worst_flow_epe). One process for all
seeds.

    python3 perfbench/calibrate_propainter.py --seeds 1 2 3

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


def readings(cell, seed, device):
    import numpy as np
    import torch
    from reference import propainter as ref
    kind = common.traffic_kind(cell["traffic"]["kind"])
    tr = cell["traffic"]
    plan = kind.pool(tr, seed)
    videos = kind.make_videos(tr, seed, device)
    sample = kind.check_sample(plan, range(len(plan)), seed,
                               tr["check_videos"])
    prog = kind.Program(cell, seed, device)
    got = []
    for k in sample:
        comp = np.stack(prog(*videos[k], keep_flows=True))
        got.append((comp, tuple(f.cpu() for f in prog.kept_flows())))
    del prog
    torch.cuda.empty_cache()
    models_ = kind.reference_models(seed, device)
    out = {"seed": seed, "lengths": [plan[k][0] for k in sample],
           "program": [0.0, 0.0, 0.0], "fp8": [0.0, 0.0],
           "tf32_epe": 0.0}
    for (comp, flows), k in zip(got, sample):
        want, wflows = kind.reference_video(models_, tr, videos[k], device)
        mae, outside = check.compare(comp, want, videos[k][1])
        epe = kind.flow_epe(flows, wflows)
        out["program"] = [max(a, b) for a, b in
                          zip(out["program"], (mae, outside, epe))]
        fp8, _ = kind.reference_video(models_, tr, videos[k], device,
                                      cell["check"]["control"])
        r = check.compare(fp8, want, videos[k][1])
        out["fp8"] = [max(a, b) for a, b in zip(out["fp8"], r)]
        fr = torch.from_numpy(videos[k][0]).to(device).permute(
            0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
        with check.tf32(True), torch.backends.cudnn.flags(enabled=False), \
                torch.no_grad():
            tf = ref.video_flows(models_[1], fr)
        tf = tuple(f.permute(0, 2, 3, 1).cpu() for f in tf)
        out["tf32_epe"] = max(out["tf32_epe"], kind.flow_epe(tf, wflows))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    common.cache_dirs()
    import torch
    torch.set_num_threads(4)
    cell = common.cell("propainter_bf16_davis480")
    device = torch.device("cuda:0")
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, device)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
