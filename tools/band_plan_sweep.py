#!/usr/bin/env python3
"""The staged banded sampler's plans (E5/E6/E1) timed against each other
on one card, and a model of its shared-memory bank conflicts.

    python3 tools/band_plan_sweep.py [--iters N]
    python3 tools/band_plan_sweep.py --bank-model

The first form builds the kernels, takes the experiments' inputs
(exp_dcn_inner_r04 at band 24, exp_dcn_pack at band 48) and, for each
variant (E5 `bf16`, E5 `base`: a float32 source with a bfloat16 output,
E6 `xpair`, E1 `cpair`: channel-pair words, planned as CG/2 channels of 4
bytes), each plan (8, 4 or 2 output rows a block, each equal channel
chunk that fits in 227 KB) and each thread width (4 or 8 consecutive x;
4 for channel pairs),
launches the kernel's C entry point directly, times N back-to-back calls
between two CUDA events (the kernels take ~0.6 ms, their host launch
~0.03) and checks the output bit-equal to the wrapper's. One JSON line
each; `picked` marks the plan band_sampler.plan chooses at the thread
width the wrapper takes.

The second form runs on the CPU: the mean bank wavefronts of one warp's
16-bit corner load from a staged bfloat16 slab at the band-24 inputs'
statistics (4 consecutive x a lane, rows y + U(-8, 8), columns x + U(-8,
8) clipped to the 108-wide map), with the rows at their 256-byte pitch
and padded by 16 bytes.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bank_wavefronts(pitch, trials=4000, seed=0, wp=128, width=108):
    """Mean wavefronts (the most distinct 32-bit words one bank serves) of
    one warp's load of a corner at row pitch `pitch` bytes."""
    rng = np.random.default_rng(seed)
    lane = np.arange(32)
    total = 0
    for _ in range(trials):
        x = 4 * lane + rng.integers(0, 4)
        row = np.floor(rng.integers(0, 64) + rng.uniform(-8, 8, 32)) \
            + rng.integers(0, 2)
        x0 = np.clip(np.floor(np.clip(x + rng.uniform(-8, 8, 32), 0,
                                      width - 1)), 0, wp - 2)
        word = ((row * pitch + 2 * (x0 + rng.integers(0, 2))) // 4)
        word = word.astype(np.int64)
        total += max(len(set(word[word % 32 == b])) for b in range(32))
    return total / trials


def sweep(iters):
    import torch
    sys.path.insert(0, ROOT)
    from e2fgvi_tpu_torch.experiments import exp_dcn_inner_r04 as ei
    from e2fgvi_tpu_torch.experiments import exp_dcn_pack as ep
    from e2fgvi_tpu_torch.kernels import band_sampler as bs
    from e2fgvi_tpu_torch.kernels import build
    from e2fgvi_tpu_torch.utils import env
    if not torch.cuda.is_available():
        raise SystemExit("band_plan_sweep: CUDA is not available")
    env.setup()
    build.build()
    lib = build.library()

    def launch(variant, src, py, px, mask, dy_lo, ty, chunk, vx):
        ng, cg, hs, wp = src.shape
        k, hp = py.shape[1], py.shape[2]
        lanes = 2 if variant == "cpair" else 1
        out = torch.empty((ng, k, lanes * cg, hp, wp), dtype=torch.bfloat16,
                          device=src.device)
        args = (src.data_ptr(), py.data_ptr(), px.data_ptr(),
                mask.data_ptr(), out.data_ptr(), ng, k, cg, hp, wp, hs - hp,
                dy_lo, ty, chunk, vx, *build.stream_args(src))
        if variant == "xpair":
            err = lib.e2fgvi_band_sample_xpair(*args)
        elif variant == "cpair":
            err = lib.e2fgvi_band_sample_cpair(*args)
        else:
            err = lib.e2fgvi_band_sample(bs._DTYPES[src.dtype], 1, *args)
        build.check(err, variant)
        return out

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    with torch.inference_mode():
        for shape, make in (("band24", ei.make_inputs),
                            ("band48", ep.make_inputs)):
            src, *pos = make("cuda")
            cg, hp, wp = src.shape[1], pos[0].shape[2], pos[0].shape[3]
            band = src.shape[2] - hp
            want = bs.band_sample(src, *pos)
            for variant, vsrc in (("bf16", src), ("base", src.float()),
                                  ("xpair", bs.pack_xpairs(src)),
                                  ("cpair", bs.pack_cpairs(src))):
                es, vcg = vsrc.element_size(), vsrc.shape[1]
                picked = bs.plan(vcg, hp, wp, band, es, pos[0].shape[1])
                lanes = 2 if variant == "cpair" else 1
                wvx = bs._vx(wp, es, lanes, *pos[:3])
                chunks = sorted({-(-vcg // n) for n in range(1, vcg + 1)})
                for ty in (8, 4, 2):
                    for chunk in chunks:
                        p = bs.make_plan(ty, chunk, vcg, wp, band, es)
                        if p.smem_bytes > bs.SMEM_MAX:
                            continue
                        for vx in (4, 8) if lanes == 1 else (4,):
                            fn = lambda: launch(variant, vsrc, *pos, ty,  # noqa: E731
                                                chunk, vx)
                            print(json.dumps({
                                "shape": shape, "variant": variant,
                                "ty": ty, "chunk": chunk, "vx": vx,
                                "smem": p.smem_bytes,
                                "picked": p == picked and vx == wvx,
                                "ms": device_ms(fn),
                                "equal": bool(torch.equal(fn(), want))}),
                                flush=True)
                del vsrc
            del src, pos, want
            torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--bank-model", action="store_true")
    args = p.parse_args(argv)
    if args.bank_model:
        for pitch in (256, 272):
            print(json.dumps({"pitch_bytes": pitch,
                              "wavefronts": bank_wavefronts(pitch)}))
    else:
        sweep(args.iters)


if __name__ == "__main__":
    main()
