"""Backward warping (grid_sample) on channel-last tensors.

Counterpart of e2fgvi_tpu/ops/warp.py: bilinear, align_corners=True, in
'zeros' (feature propagation) and 'border' (SPyNet) padding. Sampling runs
in float32; the result comes back in the input's dtype. `flow_warp` in
zeros mode is the plain version of the K2 kernel (kernels/deform.py).
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


def flow_warp(x, flow, padding_mode: str = "zeros"):
    """Warp (N, H, W, C) by a dense (N, H, W, 2) flow in pixels, (dx, dy)
    last: identity grid + flow, normalized with align_corners=True."""
    n, h, w, _ = x.shape
    if flow.shape[1:3] != (h, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not match "
                         f"image {tuple(x.shape)}")
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    fx = gx + flow[..., 0].float()
    fy = gy + flow[..., 1].float()
    nx = 2.0 * fx / max(w - 1, 1) - 1.0
    ny = 2.0 * fy / max(h - 1, 1) - 1.0
    return grid_sample_bilinear(x, torch.stack([nx, ny], dim=-1),
                                padding_mode)
