"""Backward warping on channel-last tensors.

Counterpart of e2fgvi_tpu/ops/warp.py: bilinear, align_corners=True, in
'zeros' (feature propagation) and 'border' (SPyNet) padding. Sampling runs
in float32; the result comes back in the input's dtype.

'zeros' samples at pixel positions through `bilinear_sample`, the four
corners gathered explicitly (e2fgvi_tpu/ops/dcn.py:bilinear_block_sample,
the form the JAX package's K1 and K2 sample in): it is the plain version of
the K2 kernel (kernels/deform.py) and the sampler of K1's. 'border' is
SPyNet's pyramid warp and stays on F.grid_sample, the reference's own torch
call.
"""

import torch
import torch.nn.functional as F


def grid_sample_bilinear(x, grid, padding_mode: str = "zeros"):
    """x: (N, H, W, C); grid: (N, Ho, Wo, 2) normalized (gx, gy) in [-1, 1]
    -> (N, Ho, Wo, C)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    y = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid.float(),
                      mode="bilinear", padding_mode=padding_mode,
                      align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _abs(d):
    """|d| whose derivative at 0 is +1, as jax.numpy.abs's (torch.abs's
    is 0): corner weights then have the JAX package's gradient at whole-
    pixel positions."""
    return torch.where(d >= 0, d, -d)


def bilinear_sample(x, py, px):
    """Bilinear samples of channel-last images at pixel positions, zero
    outside the image: (B, H, W, C), (B, R) float32 py, px -> (B, R, C)
    float32.

    The 2x2 block at clip(floor(p), 0, size - 2) with corner weights
    relu(1 - |p - r|): mmcv's dmcn_im2col_bilinear semantics (a corner
    outside the image contributes nothing; p <= -1 or p >= size gives 0)
    without masks, as e2fgvi_tpu/ops/dcn.py:bilinear_block_sample computes
    it. Differentiable by autograd in x and in the positions."""
    b, h, w, c = x.shape
    x = x.float()
    if h < 2 or w < 2:
        # a 1-pixel axis: zero-pad so a 2x2 block exists; the padded cells
        # get weight 0
        x = F.pad(x, (0, 0, 0, max(0, 2 - w), 0, max(0, 2 - h)))
        h, w = max(h, 2), max(w, 2)
    sy = torch.clamp(torch.floor(py), 0, h - 2)
    sx = torch.clamp(torch.floor(px), 0, w - 2)
    wy0 = torch.relu(1.0 - _abs(py - sy))
    wy1 = torch.relu(1.0 - _abs(py - (sy + 1.0)))
    wx0 = torch.relu(1.0 - _abs(px - sx))
    wx1 = torch.relu(1.0 - _abs(px - (sx + 1.0)))
    top = (sy * w + sx).long()
    xf = x.reshape(b, h * w, c)

    def corner(offset):
        idx = (top + offset)[..., None].expand(-1, -1, c)
        return torch.gather(xf, 1, idx)

    return (corner(0) * (wy0 * wx0)[..., None]
            + corner(1) * (wy0 * wx1)[..., None]
            + corner(w) * (wy1 * wx0)[..., None]
            + corner(w + 1) * (wy1 * wx1)[..., None])


def flow_warp(x, flow, padding_mode: str = "zeros"):
    """Warp (N, H, W, C) by a dense (N, H, W, 2) flow in pixels, (dx, dy)
    last. 'zeros': bilinear_sample at the pixel positions grid + flow;
    'border': F.grid_sample on the grid normalized with align_corners=True
    (the reference flow_comp.py:345-383)."""
    n, h, w, c = x.shape
    if flow.shape[1:3] != (h, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not match "
                         f"image {tuple(x.shape)}")
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    fx = gx + flow[..., 0].float()
    fy = gy + flow[..., 1].float()
    if padding_mode == "zeros":
        out = bilinear_sample(x, fy.reshape(n, h * w), fx.reshape(n, h * w))
        return out.reshape(n, h, w, c).to(x.dtype)
    nx = 2.0 * fx / max(w - 1, 1) - 1.0
    ny = 2.0 * fy / max(h - 1, 1) - 1.0
    return grid_sample_bilinear(x, torch.stack([nx, ny], dim=-1),
                                padding_mode)
