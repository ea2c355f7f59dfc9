"""Bilinear resizes and 2x2 average pooling on channel-last tensors.

Counterpart of e2fgvi_tpu/ops/resize.py, which rebuilds torch's
`F.interpolate` coordinate arithmetic as matrices for the TPU; here it is
`F.interpolate` itself, always with an explicit output size.
"""

import math

import torch.nn.functional as F


def resize_bilinear(x, out_h: int, out_w: int, align_corners: bool):
    """x: (..., H, W, C) -> (..., out_h, out_w, C)."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x4, size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def resize_scale_quarter(x):
    """F.interpolate(scale_factor=1/4, align_corners=True,
    recompute_scale_factor=True): output floor(h/4) x floor(w/4)."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, int(math.floor(h * 0.25)),
                           int(math.floor(w * 0.25)), align_corners=True)


def resize_scale2_aligned(x):
    """F.interpolate(scale_factor=2, bilinear, align_corners=True)."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, 2 * h, 2 * w, align_corners=True)


def avg_pool_2x2(x):
    """2x2 stride-2 average pooling of (N, H, W, C); odd edges dropped."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
