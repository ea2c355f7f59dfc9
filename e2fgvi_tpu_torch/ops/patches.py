"""Patch extraction (unfold) and overlap-add (fold), torch's own layout.

Counterpart of e2fgvi_tpu/ops/patches.py. The JAX package keeps patches
channel-last and kernel-major, (N, Lh, Lw, kh, kw, C), and permutes the
checkpoint's weights to match. The port keeps the reference layout
instead: NCHW images and channel-major patches (N, C*kh*kw, L), which is
what `F.unfold`/`F.fold` produce and what the released weights expect.

The fold of a patch tensor that is the same at every patch position, a
count or a bias, is a transposed convolution of a ones grid with that
patch as its kernel: `fold_counts` and `fold_bias` take that form and
never build the patch tensor.
"""

from functools import lru_cache

import torch
import torch.nn.functional as F


def unfold(x, kernel, stride=1, padding=0):
    """x: (N, C, H, W) -> (N, C*kh*kw, Lh*Lw)."""
    return F.unfold(x, kernel, padding=padding, stride=stride)


def fold(patches, output_size, kernel, stride=1, padding=0):
    """(N, C*kh*kw, L) -> (N, C, H, W), overlapping patches summed."""
    return F.fold(patches, output_size, kernel, padding=padding,
                  stride=stride)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def grid_and_output_padding(output_size, kernel, stride, padding):
    """((Lh, Lw), (oph, opw)): the patch grid of an `output_size` map
    (torch Unfold arithmetic), and the output_padding that makes a
    transposed convolution of that grid come back at `output_size`."""
    grid, extra = [], []
    for n, k, s, p in zip(*map(_pair, (output_size, kernel, stride,
                                        padding))):
        span = n + 2 * p - k
        grid.append(span // s + 1)
        extra.append(span % s)
    return tuple(grid), tuple(extra)


def _fold_const(patch, output_size, kernel, stride, padding):
    """fold of `patch` (C, kh, kw) broadcast to every patch position:
    (1, C, H, W), through one transposed convolution of a ones grid."""
    (lh, lw), out_pad = grid_and_output_padding(output_size, kernel, stride,
                                                padding)
    ones = patch.new_ones((1, 1, lh, lw))
    return F.conv_transpose2d(ones, patch[None], stride=stride,
                              padding=padding, output_padding=out_pad)


def fold_counts(output_size, kernel, stride=1, padding=0, device=None):
    """fold(ones): how many patches cover each pixel, (1, 1, H, W) float32.
    Static per geometry and device, so built once and cached."""
    return _fold_counts(*map(_pair, (output_size, kernel, stride, padding)),
                        device)


@lru_cache(maxsize=16)
def _fold_counts(output_size, kernel, stride, padding, device):
    # built outside inference mode, so that autograd may save it
    with torch.inference_mode(False), torch.no_grad():
        ones = torch.ones((1, *kernel), dtype=torch.float32, device=device)
        return _fold_const(ones, output_size, kernel, stride, padding)


def fold_bias(bias, output_size, kernel, stride, padding):
    """fold of a channel-major patch bias (C*kh*kw,) added to every patch:
    (1, C, H, W) in the bias's dtype. It depends on the weights, so it is
    computed per call, at batch 1."""
    patch = bias.reshape(-1, *_pair(kernel))
    return _fold_const(patch, output_size, kernel, stride, padding)


def fold_normalized(patches, output_size, kernel, stride=1, padding=0):
    """fold(patches) / fold(ones): the mean of the overlapping patches."""
    out = fold(patches, output_size, kernel, stride, padding)
    cnt = fold_counts(output_size, kernel, stride, padding, out.device)
    return out / cnt.to(out.dtype)
