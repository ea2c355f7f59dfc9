"""E5/E6 on the H100: inner-loop variants of the banded DCN sampler.

Counterpart of scripts/exp_dcn_inner_r04.py, at its sizes (NG = 14*16
(batch, group) tiles, 9 taps, 16 channels, a 64x128 tile, band 24):

  base     band_sample on a float32 copy of the source: float32 gathers
  bf16     band_sample on the bfloat16 source: bfloat16 gathers
  cbatch   band_sample_cbatch: weights once per position, loop over
           channels, one rounding
  packed   band_sample_xpair on pack_xpairs(source): one 32-bit load per
           (channel, row) gives both x corners; must be bit-equal to base

Each line gives the kernel's time and its plain version's.

    python -m e2fgvi_tpu_torch.experiments.exp_dcn_inner_r04 [variants] [--iters N]
"""

import argparse

import torch

from e2fgvi_tpu_torch.kernels import band_sampler as bs
from e2fgvi_tpu_torch.utils import env
from e2fgvi_tpu_torch.utils.timing import cuda_ms

VARIANTS = ("base", "bf16", "cbatch", "packed")


def make_inputs(dev, ng=14 * 16, k=9, cg=16, hp=64, wp=128, band=24,
                width=108, seed=0):
    """The script's inputs, made on `dev`: src (NG, CG, HP+band, WP)
    bfloat16 normal; py = row + U(-8, 8); px = clip(col + U(-8, 8), 0,
    width-1), the 108-wide map in a 128-wide tile; mask U(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    src = torch.randn((ng, cg, hp + band, wp), generator=g,
                      device=dev).bfloat16()
    shape = (ng, k, hp, wp)
    rows = torch.arange(hp, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(wp, dtype=torch.float32, device=dev)
    py = rows + uniform(-8, 8, shape)
    px = torch.clamp(cols + uniform(-8, 8, shape), 0, min(width, wp) - 1)
    return src, py, px, uniform(0, 1, shape), -(band // 2)


def run(src, py, px, mask, dy_lo, variants=VARIANTS, iters=10):
    """Time each variant against its plain version; returns
    {variant: {"ms", "plain_ms"}, "packed_exact": bool, ...}."""
    src32 = src.float()
    psrc = bs.pack_xpairs(src)
    kernels = {
        "base": lambda: bs.band_sample(src32, py, px, mask, dy_lo,
                                       out_dtype=torch.bfloat16),
        "bf16": lambda: bs.band_sample(src, py, px, mask, dy_lo),
        "cbatch": lambda: bs.band_sample_cbatch(src, py, px, mask, dy_lo),
        "packed": lambda: bs.band_sample_xpair(psrc, py, px, mask, dy_lo),
    }
    # base, bf16 and packed share one plain version
    plains = {
        "plain": lambda: bs.band_sample_plain(src, py, px, mask, dy_lo),
        "cbatch": lambda: bs.band_sample_cbatch_plain(src, py, px, mask,
                                                      dy_lo),
    }
    res, plain_ms = {}, {}
    for name in variants:
        ms = cuda_ms(kernels[name], iters)
        key = "cbatch" if name == "cbatch" else "plain"
        if key not in plain_ms:
            plain_ms[key] = cuda_ms(plains[key], iters)
        res[name] = {"ms": ms, "plain_ms": plain_ms[key]}
        print(f"{name:34s} {ms:8.3f} ms   plain {plain_ms[key]:8.3f} ms",
              flush=True)
    if "packed" in variants:
        res["packed_exact"] = bool(torch.equal(kernels["packed"](),
                                               kernels["base"]()))
        print(f"  exact match vs base: {res['packed_exact']}", flush=True)
    if "cbatch" in variants:
        diff = (kernels["cbatch"]().float() - kernels["base"]().float())
        res["cbatch_vs_base_max_abs"] = float(diff.abs().max())
        print(f"  cbatch vs base (one rounding vs two): max |diff| "
              f"{res['cbatch_vs_base_max_abs']:.3e}", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    help=f"any of {' '.join(VARIANTS)} (default: all)")
    ap.add_argument("--ng", type=int, default=14 * 16,
                    help="(batch, group) tiles")
    ap.add_argument("--band", type=int, default=24)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    dev = env.device()
    env.setup()
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    with torch.no_grad():
        inputs = make_inputs(dev, ng=args.ng, band=args.band)
        return run(*inputs, variants=args.variants or VARIANTS,
                   iters=args.iters)


if __name__ == "__main__":
    main()
