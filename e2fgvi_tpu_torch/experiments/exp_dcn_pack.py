"""E1 on the H100: the channel-packed banded DCN sampler.

Counterpart of scripts/exp_dcn_pack.py at its frame-step shape (B videos
x 16 groups of 16 channels, 9 taps, the 60x108 map in a 64x128 tile):
two bfloat16 channels packed per 32-bit word (pack_cpairs) are read by
one load and unpacked with a shift, against the current sampler. The
script's own baseline call is stale (it passes 4 arguments to a dispatch
that takes 6), so `current` here is the port's E5 kernel, band_sample on
the bfloat16 source. The two must agree bit for bit.

    python -m e2fgvi_tpu_torch.experiments.exp_dcn_pack [band] [B] [--iters N]
"""

import argparse

import torch

from e2fgvi_tpu_torch.kernels import band_sampler as bs
from e2fgvi_tpu_torch.utils import env
from e2fgvi_tpu_torch.utils.timing import cuda_ms

H, W, CIN, G, K = 60, 108, 256, 16, 9


def make_inputs(dev, band=48, b=14, seed=0):
    """The script's inputs, made on `dev`: src (B*G, CIN/G, HP+band, 128)
    bfloat16 normal; py = row + U(dy_lo+1, band+dy_lo-2), inside the band;
    px U(0, W); mask U(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ng, cg = b * G, CIN // G
    hp, wp = -(-H // 8) * 8, 128
    dy_lo = -(band // 2)

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    src = torch.randn((ng, cg, hp + band, wp), generator=g,
                      device=dev).bfloat16()
    shape = (ng, K, hp, wp)
    rows = torch.arange(hp, dtype=torch.float32, device=dev)[:, None]
    py = rows + uniform(dy_lo + 1, band + dy_lo - 2, shape)
    return src, py, uniform(0, W, shape), uniform(0, 1, shape), dy_lo


def run(src, py, px, mask, dy_lo, iters=10):
    """current (E5) and packed (E1) times, the plain version's, and
    max |packed - current|."""
    psrc = bs.pack_cpairs(src)
    t_cur = cuda_ms(lambda: bs.band_sample(src, py, px, mask, dy_lo), iters)
    band, b = src.shape[2] - py.shape[2], src.shape[0] // G
    print(f"current band={band} B={b}: {t_cur:.3f} ms/step", flush=True)
    t_pk = cuda_ms(lambda: bs.band_sample_cpair(psrc, py, px, mask, dy_lo),
                   iters)
    print(f"packed  band={band} B={b}: {t_pk:.3f} ms/step "
          f"({t_cur / t_pk:.2f}x)", flush=True)
    t_plain = cuda_ms(lambda: bs.band_sample_plain(src, py, px, mask, dy_lo),
                      iters)
    print(f"plain   band={band} B={b}: {t_plain:.3f} ms/step", flush=True)
    got = bs.band_sample_cpair(psrc, py, px, mask, dy_lo).float()
    want = bs.band_sample(src, py, px, mask, dy_lo).float()
    err = float((got - want).abs().max())
    print(f"max_abs_err vs current: {err:.3e}", flush=True)
    return {"current_ms": t_cur, "packed_ms": t_pk, "plain_ms": t_plain,
            "max_abs_err": err}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("band", nargs="?", type=int, default=48)
    ap.add_argument("B", nargs="?", type=int, default=14)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = env.device()
    env.setup()
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    with torch.no_grad():
        return run(*make_inputs(dev, args.band, args.B), iters=args.iters)


if __name__ == "__main__":
    main()
