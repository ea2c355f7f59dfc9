"""Patch extraction (unfold) and overlap-add (fold), torch's own layout.

Counterpart of e2fgvi_tpu/ops/patches.py. The JAX package keeps patches
channel-last and kernel-major, (N, Lh, Lw, kh, kw, C), and permutes the
checkpoint's weights to match. The port keeps the reference layout
instead: NCHW images and channel-major patches (N, C*kh*kw, L), which is
what `F.unfold`/`F.fold` produce and what the released weights expect.
"""

import torch
import torch.nn.functional as F


def unfold(x, kernel, stride=1, padding=0):
    """x: (N, C, H, W) -> (N, C*kh*kw, Lh*Lw)."""
    return F.unfold(x, kernel, padding=padding, stride=stride)


def fold(patches, output_size, kernel, stride=1, padding=0):
    """(N, C*kh*kw, L) -> (N, C, H, W), overlapping patches summed."""
    return F.fold(patches, output_size, kernel, padding=padding,
                  stride=stride)


def fold_counts(output_size, kernel, stride, padding, dtype=torch.float32,
                device=None):
    """fold(ones): how many patches cover each pixel, (1, 1, H, W)."""
    grid = F.unfold(torch.ones((1, 1, *output_size), dtype=dtype,
                               device=device),
                    kernel, padding=padding, stride=stride)
    return F.fold(torch.ones_like(grid), output_size, kernel,
                  padding=padding, stride=stride)


def fold_normalized(patches, output_size, kernel, stride=1, padding=0):
    """fold(patches) / fold(ones): the mean of the overlapping patches."""
    out = fold(patches, output_size, kernel, stride, padding)
    cnt = fold_counts(output_size, kernel, stride, padding,
                      dtype=out.dtype, device=out.device)
    return out / cnt
