"""Flow-guided second-order bidirectional feature propagation, channel-last.

Counterpart of e2fgvi_tpu/models/feat_prop.py (reference
model/modules/feat_prop.py). The recurrence is a Python loop. Deformable
alignment runs through K1 and every warp through K2 (kernels/deform.py),
and in float32 the 3x3 convolutions of the offset head and the backbone
through C (kernels/conv.py conv3x3), with their LeakyReLU and the
backbone's residual add; in bfloat16 those are cuDNN's (ops.convs.conv2d).
On CPU tensors every kernel takes its plain version.

Parameter names follow the released checkpoint:
feat_prop_module.deform_align.{backward_,forward_}.{weight,bias,conv_offset},
feat_prop_module.backbone.{backward_,forward_}, feat_prop_module.fusion.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from e2fgvi_tpu_torch.kernels import conv as kconv
from e2fgvi_tpu_torch.kernels.deform import (conv_operands, flow_warp,
                                             modulated_deform_conv2d_head)
from e2fgvi_tpu_torch.ops.convs import conv2d

DEFORM_GROUPS = 16
MAX_RESIDUE_MAGNITUDE = 10.0
_K = 9
_DIRS = ("backward", "forward")
LEAKY = 0.1


def conv3x3(x, conv, operands=None, negative_slope=None, residual=None):
    """One of the propagation's 3x3 convolutions (an nn.Conv2d's weight and
    bias) with its epilogue: for float32 CUDA tensors C (kernels.conv.
    conv3x3), which launches or raises, x and the weight taking zero
    channels up to a multiple of 4 (ProPainter's Cin 261 and 258; E2FGVI's
    widths need none) and a residual that is a frame's slice of a window
    copied whole; for bfloat16 ones (cuDNN on the tensor cores) and CPU
    tensors, C's plain form, ops.convs.conv2d and the epilogue."""
    weight = conv.weight
    act = "none" if negative_slope is None else "leaky"
    if not (x.is_cuda and x.dtype == torch.float32):
        return kconv.conv_plain(x, weight, conv.bias, residual, act,
                                negative_slope)
    pad = -x.shape[-1] % 4
    if pad:
        x = F.pad(x, (0, pad))
        weight = F.pad(weight, (0, 0, 0, 0, 0, pad))
    return kconv.conv3x3(x.contiguous(), weight, conv.bias,
                         negative_slope=negative_slope,
                         residual=None if residual is None
                         else residual.contiguous(), operands=operands)


def conv3x3_operands(convs, x):
    """C's operands of each of `convs` (kernels.conv.conv_operands) for
    float32 CUDA inputs like x, made once for all of a pass's steps; Nones
    elsewhere."""
    if not (x.is_cuda and x.dtype == torch.float32):
        return [None] * len(convs)
    return [kconv.conv_operands(c.weight, c.bias) for c in convs]


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

    def offset_convs(self):
        return [m for m in self.conv_offset if isinstance(m, nn.Conv2d)]

    def kernel_operands(self, x):
        """The DCN weight and bias reordered for K1 on CUDA inputs like x
        (kernels.deform.conv_operands), once for all of a pass's steps;
        None on the CPU."""
        if x.device.type == "cpu":
            return None
        return conv_operands(self.weight, self.bias, x.dtype,
                             self.deform_groups)

    def forward(self, x, cond, flow_1, flow_2, operands=None,
                offset_operands=None):
        """x: (N, H, W, 2C) = [first-order, second-order state];
        cond: (N, H, W, 3C) = [warped n1, current, warped n2];
        operands: kernel_operands(x), made per call when None;
        offset_operands: conv3x3_operands(offset_convs(), x), likewise."""
        convs = self.offset_convs()
        ops = offset_operands or [None] * len(convs)
        feat = torch.cat([cond, flow_1.to(cond.dtype), flow_2.to(cond.dtype)],
                         dim=-1)
        for i, c in enumerate(convs):
            feat = conv3x3(feat, c, ops[i],
                           LEAKY if i < len(convs) - 1 else None)
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

    def backbone_convs(self, direction):
        seq = self.backbone[f"{direction}_"]
        return [seq[0], seq[2]]

    def _backbone(self, direction, feat_cat, feat_prop, operands=None):
        """feat_prop + conv(LeakyReLU(conv(feat_cat))); operands:
        conv3x3_operands(backbone_convs(direction), feat_cat) or None."""
        first, second = self.backbone_convs(direction)
        ops = operands or (None, None)
        r = conv3x3(feat_cat, first, ops[0], negative_slope=LEAKY)
        return conv3x3(r, second, ops[1], residual=feat_prop)


def bidirectional_propagation(module, x, flows_backward_branch,
                              flows_forward_branch, valid_len=None,
                              remat=False):
    """Propagate features both ways and fuse (e2fgvi_tpu feat_prop.py:137).

    The flow index of each step is the step counter i-1 / i-2 for both
    directions, as in the reference (feat_prop.py:95-119), because the
    released weights were trained with it.

    x: (B, T, H, W, C); flows_*: (B, T-1, H, W, 2) float32 (dx, dy).
    valid_len: optional (B,) int tensor, the real frame count of each
    end-padded window. The backward pass meets the padding first, so its
    state is zeroed at each element's first real step and its second-order
    state at the second (the reference's cold start).
    remat: recompute each propagation step in the backward pass
    (torch.utils.checkpoint), as the JAX package's training does
    (feat_prop.py:279-283): the steps' DCN residuals are not kept.
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
        offset_ops = conv3x3_operands(align.offset_convs(), x)
        backbone_ops = conv3x3_operands(module.backbone_convs(direction), x)
        if direction == "backward":
            spatial = x.flip(1)
            flows = flows_backward_branch
        else:
            spatial = x
            flows = flows_forward_branch
        masked = first_real_step is not None and direction == "backward"

        def step(i, prev1, prev2, cur, bwd, direction=direction,
                 align=align, operands=operands, offset_ops=offset_ops,
                 backbone_ops=backbone_ops, flows=flows, masked=masked):
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
            cond = torch.cat([both[:b], cur, both[b:]], -1)
            stacked = torch.cat([prev1, feat_n2], -1)
            aligned = align(stacked, cond, flow_n1, flow_n2, operands,
                            offset_ops)
            if masked:
                # first real step: drop the alignment of padding state
                first = (first_real_step == i)[:, None, None, None]
                aligned = torch.where(first, torch.zeros_like(aligned),
                                      aligned)
            cat = [cur, aligned]
            if bwd is not None:
                cat.insert(1, bwd)
            return module._backbone(direction, torch.cat(cat, -1), aligned,
                                    backbone_ops)

        cat0 = [spatial[:, 0], zeros]
        if direction == "forward":
            cat0.insert(1, feats["backward"][0])
        outs = [module._backbone(direction, torch.cat(cat0, -1), zeros,
                                 backbone_ops)]
        prev1, prev2 = outs[0], zeros
        for i in range(1, t):
            bwd = feats["backward"][i] if direction == "forward" else None
            if remat:
                out = checkpoint(step, i, prev1, prev2, spatial[:, i], bwd,
                                 use_reentrant=False)
            else:
                out = step(i, prev1, prev2, spatial[:, i], bwd)
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
