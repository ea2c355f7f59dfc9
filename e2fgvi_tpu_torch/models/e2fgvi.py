"""E2FGVI inpainting generators (base at 432x240, HQ at any size),
channel-last.

Counterpart of e2fgvi_tpu/models/e2fgvi.py (reference
model/e2fgvi.py:133-263):

  SPyNet flows at 1/4 resolution on the local frames
  -> encoder (strided convs + group-fusion re-concats)
  -> bidirectional flow-guided deformable propagation of local features
  -> soft split -> 8 temporal focal transformer blocks -> soft composition
  -> residual add -> decoder (2x bilinear up + conv, twice) -> tanh

The two variants share every module but the soft composition: base adds
a learned bias map fixed to the 60x108 quarter-resolution grid, HQ
applies a 3x3 conv (`sc.bias_conv`) and so runs at any size whose
quarter-resolution grid tiles into the attention windows (the pipeline's
mirror pad sees to that). `Generator`'s parameter names are the released
checkpoints' keys, so E2FGVI-CVPR22.pth / E2FGVI-HQ-CVPR22.pth load with
load_state_dict(strict=True) once their recomputed buffers are dropped
(see REFERENCE_BUFFERS).
"""

import torch
import torch.nn as nn

from e2fgvi_tpu_torch.kernels import conv as kconv
from e2fgvi_tpu_torch.kernels.deform import differentiable
from e2fgvi_tpu_torch.models import feat_prop, spynet, tfocal
from e2fgvi_tpu_torch.ops.convs import conv2d, leaky_relu
from e2fgvi_tpu_torch.ops.resize import (resize_scale2_aligned,
                                         resize_scale_quarter)

CHANNEL = 256
HIDDEN = 512
DEPTHS = 8
NUM_HEADS = 4
WINDOW_SIZE = (5, 9)
OUTPUT_SIZE = (60, 108)

# (cin, cout, stride, groups); after conv 4 the 256-ch activation is
# re-concatenated group-interleaved before each later conv (reference
# Encoder, model/e2fgvi.py:71-109)
_ENC_PLAN = [
    (3, 64, 2, 1),
    (64, 64, 1, 1),
    (64, 128, 2, 1),
    (128, 256, 1, 1),
    (256, 384, 1, 1),
    (640, 512, 1, 2),
    (768, 384, 1, 4),
    (640, 256, 1, 8),
    (512, 128, 1, 1),
]
_ENC_FUSE_GROUPS = {5: 2, 6: 4, 7: 8, 8: 1}
# (upsample first?, cin, cout) at decoder indices 0, 2, 4, 6
_DEC_PLAN = [(True, 128, 128), (False, 128, 64), (True, 64, 64),
             (False, 64, 3)]
DECODE_MAX_ELEMENTS = 2**31 - 1

# registered buffers of the reference model that the released checkpoint
# carries; the port recomputes them, so they are dropped before loading
REFERENCE_BUFFERS = ("update_spynet.mean", "update_spynet.std")
REFERENCE_BUFFER_SUFFIXES = (".attn.valid_ind_rolled",
                             ".attn.valid_ind_unfold_k")


class Encoder(nn.Module):
    """in_channels: 3 (E2FGVI's masked frames) or 5 (ProPainter's frames,
    masks and updated masks)."""

    def __init__(self, in_channels=3):
        super().__init__()
        layers = []
        for i, (cin, cout, stride, groups) in enumerate(_ENC_PLAN):
            layers += [nn.Conv2d(in_channels if i == 0 else cin, cout, 3,
                                 stride, 1, groups=groups),
                       nn.LeakyReLU(0.2)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        """(B*T, H, W, in_channels) -> (B*T, H/4, W/4, 128). A float32 CUDA
        input outside autograd runs the stride-1 layers on C
        (kernels.conv.encoder_conv: bias and LeakyReLU in its epilogue, a
        grouped layer one launch a group); the stride-2 layers, bfloat16,
        the CPU and training run on ops.convs.conv2d."""
        ops = self.kernel_operands(x)
        out, x0 = x, None
        for i, (_, _, stride, groups) in enumerate(_ENC_PLAN):
            if i == 4:
                x0 = out                   # the 256-ch activation at 1/4
            if i in _ENC_FUSE_GROUPS:
                g = _ENC_FUSE_GROUPS[i]
                bt, h, w, _ = out.shape
                a = x0.reshape(bt, h, w, g, -1)
                o = out.reshape(bt, h, w, g, -1)
                out = torch.cat([a, o], -1).reshape(bt, h, w, -1)
            conv = self.layers[2 * i]
            if i in ops:
                out = kconv.encoder_conv(out, ops[i], 0.2)
            else:
                out = leaky_relu(conv2d(out, conv.weight, conv.bias,
                                        stride=stride, padding=1,
                                        groups=groups), 0.2)
        return out

    def kernel_operands(self, x):
        """C's operands (kernels.conv.group_operands) of each stride-1
        layer, by its index in _ENC_PLAN, for a float32 CUDA input outside
        autograd, made once a call; {} elsewhere (C's backward would
        recompute on cuDNN and cost more than cuDNN's own)."""
        if not (x.is_cuda and x.dtype == torch.float32) or differentiable(
                x, *self.parameters()):
            return {}
        return {i: kconv.group_operands(self.layers[2 * i].weight,
                                        self.layers[2 * i].bias, groups)
                for i, (_, _, stride, groups) in enumerate(_ENC_PLAN)
                if stride == 1}


class Deconv(nn.Module):
    """2x bilinear upsample + 3x3 conv; the conv is stored as `.conv`."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)


VARIANTS = ("base", "hq")


class Generator(nn.Module):
    family = "e2fgvi"

    def __init__(self, variant: str = "base"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} not in {VARIANTS}")
        self.variant = variant
        c = CHANNEL // 2
        self.encoder = Encoder()
        dec = []
        for i, (up, cin, cout) in enumerate(_DEC_PLAN):
            dec.append(Deconv(cin, cout) if up
                       else nn.Conv2d(cin, cout, 3, padding=1))
            if i < len(_DEC_PLAN) - 1:
                dec.append(nn.LeakyReLU(0.2))
        self.decoder = nn.Sequential(*dec)
        self.feat_prop_module = feat_prop.FeatPropModule(c)
        self.ss = tfocal.SoftSplit(c, HIDDEN)
        self.sc = tfocal.SoftComp(
            c, HIDDEN, OUTPUT_SIZE if variant == "base" else None)
        self.transformer = nn.ModuleList(
            tfocal.TemporalFocalTransformerBlock(HIDDEN, WINDOW_SIZE)
            for _ in range(DEPTHS))
        self.update_spynet = spynet.SPyNet()

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """Random init with the JAX package's distributions: N(0, 0.02)
        convs and embeddings, zero biases, a zero last offset-head layer,
        mean pooling, He-normal SPyNet."""
        def normal_(t, std=0.02):
            t.copy_(torch.randn(t.shape, generator=gen) * std)

        for m in list(self.encoder.modules()) + list(self.decoder.modules()) \
                + list(self.feat_prop_module.modules()):
            if isinstance(m, nn.Conv2d):
                normal_(m.weight)
                m.bias.zero_()
        for d in self.feat_prop_module.deform_align.values():
            normal_(d.weight)
            d.bias.zero_()
            d.conv_offset[-1].weight.zero_()
        for lin in (self.ss.embedding, self.sc.embedding):
            normal_(lin.weight)
            lin.bias.zero_()
        if self.variant == "base":
            self.sc.bias.zero_()
        else:
            normal_(self.sc.bias_conv.weight)
            self.sc.bias_conv.bias.zero_()
        for block in self.transformer:
            block.init_weights(gen)
        self.update_spynet.init_weights(gen)
        return self

    def forward(self, masked_frames, num_local_frames, remat=False):
        """generator_forward on this model: the entry DistributedDataParallel
        wraps for training."""
        return generator_forward(self, masked_frames, num_local_frames,
                                 remat)

    def decode(self, x):
        """(B*T, H/4, W/4, 128) -> (B*T, H, W, 3), before tanh. Frames go
        through in chunks whose widest activation (64 channels at full
        resolution) stays below 2^31 elements, the most PyTorch's CUDA
        bilinear upsample takes: at 864x480 that is 80 frames, fewer than
        the 154 of a 14-window batch."""
        n, hq, wq, _ = x.shape
        step = max(1, DECODE_MAX_ELEMENTS // (64 * 16 * hq * wq))
        if n > step:
            return torch.cat([self.decode(x[s: s + step])
                              for s in range(0, n, step)])
        convs = [m for m in self.decoder if not isinstance(m, nn.LeakyReLU)]
        for i, ((up, _, _), m) in enumerate(zip(_DEC_PLAN, convs)):
            if up:
                x = resize_scale2_aligned(x)
                m = m.conv
            x = conv2d(x, m.weight, m.bias, padding=1)
            if i < len(_DEC_PLAN) - 1:
                x = leaky_relu(x, 0.2)
        return x


def load_reference_state_dict(model: Generator, sd: dict):
    """Load a reference checkpoint state dict with strict=True after
    dropping the buffers the port recomputes. A base checkpoint refuses to
    load into an HQ model and the reverse (`sc.bias` against
    `sc.bias_conv.*`)."""
    keep = {k: v for k, v in sd.items()
            if k not in REFERENCE_BUFFERS
            and not k.endswith(REFERENCE_BUFFER_SUFFIXES)}
    return model.load_state_dict(keep, strict=True)


def spynet_pairs(flow_net, small_pairs_a, small_pairs_b):
    """Flows a->b and b->a of quarter-res frame pairs (N, hs, ws, 3) in
    [0, 1] by the SPyNet `flow_net` (a generator's update_spynet, or
    training's frozen copy), both directions in one batch. Returns
    (forward, backward), each (N, hs, ws, 2) float32."""
    n = small_pairs_a.shape[0]
    both = flow_net(torch.cat([small_pairs_a, small_pairs_b], 0),
                    torch.cat([small_pairs_b, small_pairs_a], 0))
    return both[:n], both[n:]


def forward_bidirect_flow(flow_net, masked_local_frames):
    """(B, L, H, W, 3) in [0, 1] -> (flows_forward, flows_backward), each
    (B, L-1, H/4, W/4, 2), by the SPyNet `flow_net` (spynet_pairs;
    reference model/e2fgvi.py:210-234)."""
    b, lt, h, w, _ = masked_local_frames.shape
    small = resize_scale_quarter(masked_local_frames.reshape(b * lt, h, w, 3))
    hs, ws = small.shape[1], small.shape[2]
    small = small.reshape(b, lt, hs, ws, 3)
    f1 = small[:, :-1].reshape(-1, hs, ws, 3)
    f2 = small[:, 1:].reshape(-1, hs, ws, 3)
    ff, fb = spynet_pairs(flow_net, f1, f2)
    return (ff.reshape(b, lt - 1, hs, ws, 2),
            fb.reshape(b, lt - 1, hs, ws, 2))


def window_stage(model, feat, pred_flows, num_local_frames, num_out=None,
                 valid_local=None, frame_valid=None, mark=None, remat=False):
    """Everything downstream of the encoder and SPyNet for a batch of
    windows: propagation, soft split, transformer, soft comp, decode.

    feat: (B, T, H/4, W/4, C), local frames first; pred_flows:
    (flows_forward, flows_backward), each (B, L-1, H/4, W/4, 2).
    num_out: decode only the first num_out frames (None: all T).
    valid_local: optional (B,) real local-frame counts of end-padded
    windows; frame_valid: optional (B, T) bool frame validity.
    mark: optional callable, called with a stage name as each of
    'feat_prop', 'transformer' and 'decode' ends (stage timing).
    remat: recompute each propagation step and transformer block in the
    backward pass (training; off for serving).
    Returns (B, num_out, H, W, 3) tanh output in [-1, 1]."""
    lt = num_local_frames
    b, t, hq, wq, c = feat.shape
    n_out = t if num_out is None else num_out

    local_feat = feat_prop.bidirectional_propagation(
        model.feat_prop_module, feat[:, :lt], pred_flows[0], pred_flows[1],
        valid_len=valid_local, remat=remat)
    enc_feat = torch.cat([local_feat, feat[:, lt:]], 1)
    if mark:
        mark("feat_prop")

    output_size = (hq, wq)
    tokens = tfocal.soft_split(model.ss, enc_feat.reshape(b * t, hq, wq, c),
                               b)
    tokens = tfocal.transformer_stack(model.transformer, tokens, output_size,
                                      NUM_HEADS, WINDOW_SIZE,
                                      frame_valid=frame_valid, remat=remat)
    trans_feat = tfocal.soft_comp(model.sc, tokens[:, :n_out], n_out,
                                  output_size)
    out_feat = enc_feat[:, :n_out] + trans_feat.reshape(b, n_out, hq, wq, c)
    if mark:
        mark("transformer")

    out = model.decode(out_feat.reshape(b * n_out, hq, wq, c))
    out = torch.tanh(out).reshape(b, n_out, *out.shape[1:])
    if mark:
        mark("decode")
    return out


def generator_forward(model, masked_frames, num_local_frames, remat=False):
    """masked_frames: (B, T, H, W, 3) in [-1, 1], local frames first.
    Returns ((B*T, H, W, 3) tanh output, (flows_forward, flows_backward)),
    differentiable where grad mode is on (e2fgvi_tpu/models/e2fgvi.py:238).
    remat: see window_stage."""
    lt = num_local_frames
    b, t, h, w, _ = masked_frames.shape
    pred_flows = forward_bidirect_flow(model.update_spynet,
                                       (masked_frames[:, :lt] + 1.0) / 2.0)
    enc_feat = model.encoder(masked_frames.reshape(b * t, h, w, 3))
    hq, wq, c = enc_feat.shape[1:]
    enc_feat = enc_feat.reshape(b, t, hq, wq, c)
    out = window_stage(model, enc_feat, pred_flows, lt, remat=remat)
    return out.reshape(b * t, h, w, 3), pred_flows
