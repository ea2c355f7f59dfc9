"""SPyNet optical flow (6-level spatial pyramid), channel-last.

Counterpart of e2fgvi_tpu/models/spynet.py (reference
model/modules/flow_comp.py:49-226). Parameter names follow the released
checkpoint: update_spynet.basic_module.{level}.basic_module.{m}.conv.*.
The pyramid's border-padded warp runs through F.grid_sample (ops.warp), as
the JAX package runs it outside Pallas.
"""

import numpy as np
import torch
import torch.nn as nn

from e2fgvi_tpu_torch.ops.convs import conv2d
from e2fgvi_tpu_torch.ops.resize import avg_pool_2x2, resize_bilinear
from e2fgvi_tpu_torch.ops.warp import flow_warp

# ImageNet normalisation (reference flow_comp.py:77-82 buffers)
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
LEVELS = 6
CHANNELS = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]


class ConvModule(nn.Module):
    """A conv stored as `.conv`, as in the released checkpoint's keys."""

    def __init__(self, cin, cout, k=7):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)


class BasicModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(
            ConvModule(cin, cout) for cin, cout in CHANNELS)

    def forward(self, x):
        for i, m in enumerate(self.basic_module):
            x = conv2d(x, m.conv.weight, m.conv.bias, padding=3)
            if i < len(CHANNELS) - 1:
                x = torch.relu(x)
        return x


class SPyNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(BasicModule() for _ in range(LEVELS))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """He-normal convs and zero biases, as the JAX init."""
        for mod in self.basic_module:
            for m in mod.basic_module:
                w = m.conv.weight
                std = float(np.sqrt(2.0 / (w.shape[1] * 7 * 7)))
                w.copy_(torch.randn(w.shape, generator=gen) * std)
                m.conv.bias.zero_()

    def compute_flow(self, ref, supp):
        """ref/supp: (N, H, W, 3) in [0, 1], H and W multiples of 32."""
        n, h, w, _ = ref.shape
        mean = torch.as_tensor(_MEAN, dtype=ref.dtype, device=ref.device)
        std = torch.as_tensor(_STD, dtype=ref.dtype, device=ref.device)
        refs = [(ref - mean) / std]
        supps = [(supp - mean) / std]
        for _ in range(LEVELS - 1):
            refs.append(avg_pool_2x2(refs[-1]))
            supps.append(avg_pool_2x2(supps[-1]))
        refs, supps = refs[::-1], supps[::-1]

        flow = torch.zeros((n, h // 32, w // 32, 2), dtype=ref.dtype,
                           device=ref.device)
        for level in range(LEVELS):
            if level == 0:
                flow_up = flow
            else:
                fh, fw = flow.shape[1], flow.shape[2]
                flow_up = resize_bilinear(flow, 2 * fh, 2 * fw,
                                          align_corners=True) * 2.0
            warped = flow_warp(supps[level], flow_up, padding_mode="border")
            inp = torch.cat([refs[level], warped, flow_up], dim=-1)
            flow = flow_up + self.basic_module[level](inp)
        return flow

    def forward(self, ref, supp):
        """Flow from ref to supp, (N, H, W, 2) float32 pixels (dx, dy).

        Resizes to multiples of 32 and back, rescaling the flow by the size
        ratio (reference flow_comp.py:136-169)."""
        h, w = ref.shape[1], ref.shape[2]
        w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
        h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
        ref_u = resize_bilinear(ref, h_up, w_up, align_corners=False)
        supp_u = resize_bilinear(supp, h_up, w_up, align_corners=False)
        flow = self.compute_flow(ref_u, supp_u)
        flow = resize_bilinear(flow, h, w, align_corners=False)
        scale = torch.tensor([w / w_up, h / h_up], dtype=torch.float32,
                             device=flow.device)
        return flow.float() * scale
