#!/usr/bin/env python3
"""Readings for the limits of the vace cell: on each seed, on the video a
run checks, the numbers the run compares for the program (sound runs:
the lower readings) and for the control (the upper readings): the plain
reference with every product's operands rounded to fp8 (`check.control`)
in the program's place, given the same latent, timestep and context for
the velocity and the same final latent for the frames. Then the
velocities of three broken bfloat16 programs at the same inputs, each of
which the limit must refuse: the context branch dropped (no hints), RoPE
dropped, and the modulation's float32 dropped (the time embedding, the
modulations and the residual stream in bfloat16). One process for all
seeds.

    python3 perfbench/calibrate_wan_vace.py --seeds 1 2 3

Prints one JSON line a seed. The benchmark's runs never run this.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import check, common  # noqa: E402

CELL = "vace_bf16_objmask480"


@contextlib.contextmanager
def fault(model, name):
    """The port's DiT broken as `name` says, undone on exit."""
    import torch
    from e2fgvi_tpu_torch.models import wan_dit
    dit = model.dit
    saved = {}
    if name == "no_hints":
        saved["hint_of"], dit.hint_of = dit.hint_of, {}
    elif name == "no_rope":
        saved["rope"] = wan_dit.rope_apply
        wan_dit.rope_apply = lambda x, cos, sin: x.float()
    elif name == "bf16_modulation":
        saved["params"] = {n: p.data for n, p in dit.named_parameters()
                           if p.dtype == torch.float32}
        for n, p in dit.named_parameters():
            p.data = p.data.to(torch.bfloat16)
        saved["emb"] = wan_dit.sinusoidal_embedding
        wan_dit.sinusoidal_embedding = lambda dim, t: saved["emb"](
            dim, t.to(torch.bfloat16)).to(torch.bfloat16)
    try:
        yield
    finally:
        if "hint_of" in saved:
            dit.hint_of = saved["hint_of"]
        if "rope" in saved:
            wan_dit.rope_apply = saved["rope"]
        if "params" in saved:
            for n, p in dit.named_parameters():
                if n in saved["params"]:
                    p.data = saved["params"][n]
            wan_dit.sinusoidal_embedding = saved["emb"]


def guided(model, kept):
    import torch
    with torch.inference_mode():
        d = model.dit
        x, t, ctx = kept["latent"], kept["timestep"], kept["context"]
        v_c = d(x, t, ctx, model.context)
        v_u = d(x, t, ctx, model.context_null)
        return v_u + model.guidance * (v_c - v_u)


def readings(cell, seed, device):
    import numpy as np
    import torch
    kind = common.traffic_kind(cell["traffic"]["kind"])
    cfg, tr = cell["config"], cell["traffic"]
    plan = kind.pool(tr, seed)
    videos = kind.make_videos(tr, seed, device)
    k = kind.check_sample(plan, range(len(plan)), seed, 1)[0]
    step = kind.check_step(cfg, seed)
    prog = kind.Program(cell, seed, device)
    got = np.stack(prog(*videos[k], keep_step=step))
    kept = prog.kept()
    faults = {}
    for name in ("no_hints", "no_rope", "bf16_modulation"):
        with fault(prog.model, name):
            faults[name] = guided(prog.model, kept)
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    refs = kind.reference_models(cfg, seed, device)
    out = {"seed": seed, "length": plan[k][0], "step": step}
    v = kind.reference_velocity(refs, cfg, kept)
    want = kind.reference_frames(refs, kept, videos[k])
    out["program"] = list(check.compare(got, want, videos[k][1])) + [
        kind.velocity_rel(kept["velocity"], v)]
    out["faults_velocity_rel"] = {n: kind.velocity_rel(f, v)
                                  for n, f in faults.items()}
    control = cell["check"]["control"]
    v8 = kind.reference_velocity(refs, cfg, kept, control)
    f8 = kind.reference_frames(refs, kept, videos[k], control)
    out["fp8"] = list(check.compare(f8, want, videos[k][1])) + [
        kind.velocity_rel(v8, v)]
    out["velocity_norm"] = float(v.norm())
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    common.cache_dirs()
    import torch
    torch.set_num_threads(4)
    cell = common.cell(CELL)
    device = torch.device("cuda:0")
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, device)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
