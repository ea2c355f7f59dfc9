"""E3/E4 on the H100: DCN gather formulations at the DCN's shape.

Counterpart of scripts/exp_gather.py: a 60x108 feature map, 9 taps, 16
deformable groups x 8 channels = 128 lanes, P = 6480 rows per tap.

  v1    the plain torch.gather of a (P, 128) row table with per-lane
        indices (the script's XLA take_along_axis row)
  v2    E3 row_gather, float32 table
  v2b   E3 row_gather, bfloat16 table
  v3    E4 bilinear4_sample: the four bilinear corners and weights fused,
        lane j taking group j % 16

Each variant prints a correctness line against its plain version, then
ms per call and M rows/s (58320 gathered rows per call). The script's
round-1 block gather (v0) is not a kernel and has no counterpart; its
chained-iteration timing existed for a remote link and is replaced by
CUDA events.

    python -m e2fgvi_tpu_torch.experiments.exp_gather [variants] [--iters N]
"""

import argparse

import torch

from e2fgvi_tpu_torch.kernels import gather
from e2fgvi_tpu_torch.utils import env
from e2fgvi_tpu_torch.utils.timing import cuda_ms

C, KTAPS, GROUPS = 128, 9, 16
VARIANTS = ("v1", "v2", "v2b", "v3")


def make_inputs(dev, h=60, w=108, seed=0):
    """The script's inputs, made on `dev`: tab (P, 128) normal; idx (9, P,
    128) with the 8 lanes of a group sharing one index, as a real DCN's
    do; py/px (9, P, 16) uniform inside the map."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = h * w
    tab = torch.randn((p, C), generator=g, device=dev)
    idx = torch.randint(0, p, (KTAPS * p, GROUPS, 1), generator=g,
                        device=dev, dtype=torch.int32)
    idx = idx.expand(-1, -1, C // GROUPS).reshape(KTAPS, p, C).contiguous()
    py = torch.rand((KTAPS, p, GROUPS), generator=g, device=dev) * (h - 1)
    px = torch.rand((KTAPS, p, GROUPS), generator=g, device=dev) * (w - 1)
    return tab, idx, py, px


def run(tab, idx, py, px, h, w, variants=VARIANTS, iters=10):
    rows = idx.shape[0] * idx.shape[1]
    tab16 = tab.bfloat16()
    calls = {
        "v1": (lambda: gather.row_gather_plain(tab, idx), None),
        "v2": (lambda: gather.row_gather(tab, idx),
               lambda: gather.row_gather_plain(tab, idx)),
        "v2b": (lambda: gather.row_gather(tab16, idx),
                lambda: gather.row_gather_plain(tab16, idx)),
        "v3": (lambda: gather.bilinear4_sample(tab, py, px, h, w),
               lambda: gather.bilinear4_sample_plain(tab, py, px, h, w)),
    }
    res = {}
    for name in variants:
        fn, plain = calls[name]
        out = {}
        if plain is not None:
            out["max_err"] = float((fn().float() - plain().float()).abs()
                                   .max())
            print(f"{name} correctness: max_err={out['max_err']:.2e}",
                  flush=True)
            out["plain_ms"] = cuda_ms(plain, iters)
        out["ms"] = cuda_ms(fn, iters)
        print(f"{name}: {out['ms']:.3f} ms/call  "
              f"{rows / out['ms'] / 1e3:.1f}M rows/s"
              + (f"  (plain {out['plain_ms']:.3f} ms)" if plain else ""),
              flush=True)
        res[name] = out
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    help=f"any of {' '.join(VARIANTS)} (default: all)")
    ap.add_argument("--height", type=int, default=60)
    ap.add_argument("--width", type=int, default=108)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    dev = env.device()
    env.setup()
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    with torch.no_grad():
        inputs = make_inputs(dev, args.height, args.width)
        return run(*inputs, args.height, args.width,
                   variants=args.variants or VARIANTS, iters=args.iters)


if __name__ == "__main__":
    main()
