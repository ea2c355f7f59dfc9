"""Flow-guided second-order bidirectional feature propagation, channel-last.

Counterpart of e2fgvi_tpu/models/feat_prop.py (reference
model/modules/feat_prop.py). The recurrence is a Python loop. Deformable
alignment runs through K1 and every warp through K2 (kernels/deform.py);
on CPU tensors both take their plain versions.

Parameter names follow the released checkpoint:
feat_prop_module.deform_align.{backward_,forward_}.{weight,bias,conv_offset},
feat_prop_module.backbone.{backward_,forward_}, feat_prop_module.fusion.
"""

import torch
import torch.nn as nn

from e2fgvi_tpu_torch.kernels.deform import (conv_operands, flow_warp,
                                             modulated_deform_conv2d_head)
from e2fgvi_tpu_torch.ops.convs import conv2d, leaky_relu

DEFORM_GROUPS = 16
MAX_RESIDUE_MAGNITUDE = 10.0
_K = 9
_DIRS = ("backward", "forward")


class SecondOrderDeformableAlignment(nn.Module):
    """DCNv2 weight (channel, 2*channel, 3, 3) plus the offset head."""

    def __init__(self, channel, deform_groups=DEFORM_GROUPS):
        super().__init__()
        self.deform_groups = deform_groups
        self.weight = nn.Parameter(torch.zeros(channel, 2 * channel, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channel))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * channel + 4, channel, 3, padding=1),
            nn.LeakyReLU(0.1),
            nn.Conv2d(channel, channel, 3, padding=1),
            nn.LeakyReLU(0.1),
            nn.Conv2d(channel, channel, 3, padding=1),
            nn.LeakyReLU(0.1),
            nn.Conv2d(channel, 27 * deform_groups, 3, padding=1),
        )

    def kernel_operands(self, x):
        """The DCN weight and bias reordered for K1 on CUDA inputs like x
        (kernels.deform.conv_operands), once for all of a pass's steps;
        None on the CPU."""
        if x.device.type == "cpu":
            return None
        return conv_operands(self.weight, self.bias, x.dtype,
                             self.deform_groups)

    def forward(self, x, cond, flow_1, flow_2, operands=None):
        """x: (N, H, W, 2C) = [first-order, second-order state];
        cond: (N, H, W, 3C) = [warped n1, current, warped n2];
        operands: kernel_operands(x), made per call when None."""
        convs = [m for m in self.conv_offset if isinstance(m, nn.Conv2d)]
        feat = torch.cat([cond, flow_1.to(cond.dtype), flow_2.to(cond.dtype)],
                         dim=-1)
        for i, c in enumerate(convs):
            feat = conv2d(feat, c.weight, c.bias, padding=1)
            if i < len(convs) - 1:
                feat = leaky_relu(feat, 0.1)
        return modulated_deform_conv2d_head(
            x, feat, flow_1, flow_2, self.weight, self.bias,
            max_residue=MAX_RESIDUE_MAGNITUDE, operands=operands)


class FeatPropModule(nn.Module):
    def __init__(self, channel=128, deform_groups=DEFORM_GROUPS):
        super().__init__()
        self.deform_align = nn.ModuleDict({
            f"{d}_": SecondOrderDeformableAlignment(channel, deform_groups)
            for d in _DIRS})
        self.backbone = nn.ModuleDict({
            f"{d}_": nn.Sequential(
                nn.Conv2d((2 + i) * channel, channel, 3, padding=1),
                nn.LeakyReLU(0.1),
                nn.Conv2d(channel, channel, 3, padding=1))
            for i, d in enumerate(_DIRS)})
        self.fusion = nn.Conv2d(2 * channel, channel, 1)

    def _backbone(self, direction, feat_cat, feat_prop):
        seq = self.backbone[f"{direction}_"]
        r = leaky_relu(conv2d(feat_cat, seq[0].weight, seq[0].bias,
                              padding=1), 0.1)
        return feat_prop + conv2d(r, seq[2].weight, seq[2].bias, padding=1)


def bidirectional_propagation(module, x, flows_backward_branch,
                              flows_forward_branch, valid_len=None):
    """Propagate features both ways and fuse (e2fgvi_tpu feat_prop.py:137).

    The flow index of each step is the step counter i-1 / i-2 for both
    directions, as in the reference (feat_prop.py:95-119), because the
    released weights were trained with it.

    x: (B, T, H, W, C); flows_*: (B, T-1, H, W, 2) float32 (dx, dy).
    valid_len: optional (B,) int tensor, the real frame count of each
    end-padded window. The backward pass meets the padding first, so its
    state is zeroed at each element's first real step and its second-order
    state at the second (the reference's cold start).
    Returns (B, T, H, W, C): fused propagated features + x."""
    b, t, h, w, c = x.shape
    first_real_step = None
    if valid_len is not None:
        first_real_step = (t - valid_len.to(x.device)).long()
    zeros = x.new_zeros((b, h, w, c))
    feats = {}
    for direction in _DIRS:
        align = module.deform_align[f"{direction}_"]
        operands = align.kernel_operands(x)
        if direction == "backward":
            spatial = x.flip(1)
            flows = flows_backward_branch
        else:
            spatial = x
            flows = flows_forward_branch
        masked = first_real_step is not None and direction == "backward"

        cat0 = [spatial[:, 0], zeros]
        if direction == "forward":
            cat0.insert(1, feats["backward"][0])
        outs = [module._backbone(direction, torch.cat(cat0, -1), zeros)]
        prev1, prev2 = outs[0], zeros
        for i in range(1, t):
            flow_n1 = flows[:, i - 1].float()
            f2 = flows[:, max(i - 2, 0)].float()
            use2 = torch.full((b,), float(i > 1), device=x.device)
            if masked:
                use2 = use2 * (first_real_step + 1 != i).float()
            use2 = use2[:, None, None, None]
            feat_n2 = prev2 * use2.to(x.dtype)
            flow_n2 = (flow_n1 + flow_warp(f2, flow_n1)) * use2
            # both 128-channel feature warps in one launch
            both = flow_warp(torch.cat([prev1, feat_n2], 0),
                             torch.cat([flow_n1, flow_n2], 0))
            cond = torch.cat([both[:b], spatial[:, i], both[b:]], -1)
            stacked = torch.cat([prev1, feat_n2], -1)
            aligned = align(stacked, cond, flow_n1, flow_n2, operands)
            if masked:
                # first real step: drop the alignment of padding state
                first = (first_real_step == i)[:, None, None, None]
                aligned = torch.where(first, torch.zeros_like(aligned),
                                      aligned)
            cat = [spatial[:, i], aligned]
            if direction == "forward":
                cat.insert(1, feats["backward"][i])
            out = module._backbone(direction, torch.cat(cat, -1), aligned)
            prev1, prev2 = out, prev1
            outs.append(out)
        if direction == "backward":
            outs = outs[::-1]
        feats[direction] = outs

    fb = torch.stack(feats["backward"], 1)
    ff = torch.stack(feats["forward"], 1)
    cat = torch.cat([fb, ff], -1).reshape(b * t, h, w, 2 * c)
    fused = conv2d(cat, module.fusion.weight, module.fusion.bias)
    return fused.reshape(b, t, h, w, c) + x
