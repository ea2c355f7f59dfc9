"""E2 on the H100: band-assembled focal attention against K3.

Counterpart of scripts/exp_attn_band_r04.py at its sizes (B = 14 windows
of T = 17 frames, a 20x36 token grid, C = 512, 4 heads, (5, 9) windows,
(2, 4) expansion, bfloat16). One random transformer block from an
explicit torch.Generator; the same normalized tokens and pooled tokens go
through

  window_attention(K3)   tfocal.window_attention: the q partition, one
                         key panel per window gathered through the
                         deduplicated key table, then the K3 kernel
  band_attention(E2)     kernels/band_attention.py: q/k/v read in place
                         from the qkv map, keys from static geometry

and the script's lines are printed: both times, parity, and parity with
frame_valid over valid queries (padding frames' queries are garbage that
callers discard).

    python -m e2fgvi_tpu_torch.experiments.exp_attn_band_r04 [--batch B] [--iters N]
"""

import argparse

import torch

from e2fgvi_tpu_torch.kernels.band_attention import band_attention
from e2fgvi_tpu_torch.models import tfocal
from e2fgvi_tpu_torch.utils import env
from e2fgvi_tpu_torch.utils.timing import cuda_ms

T, HH, WW, C = 17, 20, 36, 512
HEADS, WIN, EXP = 4, (5, 9), (2, 4)


def make_block(dev, b=14, t=T, c=C, seed=0, h=HH, w=WW):
    """(block, x, pooled): a bfloat16 inference block with N(0, 0.02)
    weights, normal tokens on an h x w grid and their pooled tokens, made
    on `dev`."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    block = tfocal.TemporalFocalTransformerBlock(c, WIN)
    block.init_weights(g)
    block = block.to(dev, torch.bfloat16).eval().requires_grad_(False)
    gd = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, t, h, w, c), generator=gd, device=dev).bfloat16()
    return block, x, tfocal._pool_level(block, x, WIN)


def frame_valid_mask(b, t, dev):
    """The script's padding pattern: the last 3 frames of window 0 and the
    last frame of window 1 are padding."""
    fv = torch.ones((b, t), dtype=torch.bool, device=dev)
    fv[0, -3:] = False
    fv[1, -1] = False
    return fv


def valid_query_err(got, want, fv):
    """max |got - want| over the queries of valid frames; (B*nWin, T*wh*ww,
    C) outputs, t-major queries per window."""
    b = fv.shape[0]
    nwin = got.shape[0] // b
    valid = fv.repeat_interleave(WIN[0] * WIN[1], 1)
    valid = valid.repeat_interleave(nwin, 0)[..., None]
    return float(torch.where(valid, (got.float() - want.float()).abs(),
                             0.0).max())


def run(block, x, pooled, iters=10):
    attn = block.attn
    args = (attn, x, pooled, HEADS, WIN, EXP)
    res = {"k3_ms": cuda_ms(lambda: tfocal.window_attention(*args), iters)}
    print(f"window_attention(K3)           {res['k3_ms']:8.3f} ms",
          flush=True)
    res["e2_ms"] = cuda_ms(lambda: band_attention(*args), iters)
    print(f"band_attention(E2)             {res['e2_ms']:8.3f} ms",
          flush=True)
    got = band_attention(*args).float()
    want = tfocal.window_attention(*args).float()
    err = float((got - want).abs().max())
    res["parity_max_abs"] = err
    res["parity_rel"] = err / float(want.abs().max())
    print(f"parity max|band-K3| = {err:.3e} (rel {res['parity_rel']:.3e})",
          flush=True)
    fv = frame_valid_mask(x.shape[0], x.shape[1], x.device)
    got = band_attention(*args, frame_valid=fv)
    want = tfocal.window_attention(*args, frame_valid=fv)
    res["parity_fv_max_abs"] = valid_query_err(got, want, fv)
    res["parity_fv_rel"] = res["parity_fv_max_abs"] / float(
        want.float().abs().max())
    print(f"parity (frame_valid)           = "
          f"{res['parity_fv_max_abs']:.3e} (rel {res['parity_fv_rel']:.3e})",
          flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=14,
                    help="windows per batch")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = env.device()
    env.setup()
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    with torch.no_grad():
        return run(*make_block(dev, args.batch), iters=args.iters)


if __name__ == "__main__":
    main()
