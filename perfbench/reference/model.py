"""E2FGVI's generator (base and HQ) in plain PyTorch: the benchmark's
reference.

It imports nothing of the program under test. Its module tree has the
released checkpoints' parameter names (MCG-NKU/E2FGVI model/e2fgvi.py,
model/e2fgvi_hq.py), so the one state dict the benchmark makes loads into
both. The forward is a frozen copy of the port's plain paths, channel-last,
with three departures that keep it independent of how the port computes:

- focal attention is the reference's own math: every query of a window
  attends to the window's tokens, the four rolled out-of-window key sets
  and the unfolded pooled keys (-100 outside the pooled grid) of every
  frame, through one static gather table; no key is deduplicated;
- soft split, soft comp and F3N are the literal unfold / Linear / fold
  chains, not convolutions;
- a window runs alone, at its own length, with no end padding.

Every product (conv, Linear, einsum) goes through `Ops`: float32, or with
both operands rounded to a narrower type first (the control).
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CHANNEL = 256
HIDDEN = 512
DEPTHS = 8
NUM_HEADS = 4
WINDOW = (5, 9)
OUTPUT_SIZE = (60, 108)
D_FF = 1960
DEFORM_GROUPS = 16
MAX_RESIDUE = 10.0
T2T_KERNEL, T2T_STRIDE, T2T_PADDING = (7, 7), (3, 3), (3, 3)
# (cin, cout, stride, groups); from conv 5 on the 256-ch activation of
# conv 4's input is re-concatenated group-interleaved (reference Encoder)
ENC_PLAN = [(3, 64, 2, 1), (64, 64, 1, 1), (64, 128, 2, 1),
            (128, 256, 1, 1), (256, 384, 1, 1), (640, 512, 1, 2),
            (768, 384, 1, 4), (640, 256, 1, 8), (512, 128, 1, 1)]
ENC_FUSE_GROUPS = {5: 2, 6: 4, 7: 8, 8: 1}
DEC_PLAN = [(True, 128, 128), (False, 128, 64), (True, 64, 64),
            (False, 64, 3)]
SPYNET_LEVELS = 6
SPYNET_CHANNELS = [(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)]
SPYNET_MEAN = (0.485, 0.456, 0.406)
SPYNET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# Parameter tree (names and shapes only)
# ---------------------------------------------------------------------------

class _Wrap(nn.Module):
    def __init__(self, cin, cout, k=3, padding=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=padding)


class _Align(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, 2 * c, 3, 3))
        self.bias = nn.Parameter(torch.empty(c))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * c + 4, c, 3, padding=1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, 27 * DEFORM_GROUPS, 3, padding=1))


class _FeatProp(nn.Module):
    def __init__(self, c):
        super().__init__()
        dirs = ("backward_", "forward_")
        self.deform_align = nn.ModuleDict({d: _Align(c) for d in dirs})
        self.backbone = nn.ModuleDict({
            d: nn.Sequential(nn.Conv2d((2 + i) * c, c, 3, padding=1),
                             nn.LeakyReLU(0.1), nn.Conv2d(c, c, 3, padding=1))
            for i, d in enumerate(dirs)})
        self.fusion = nn.Conv2d(2 * c, c, 1)


class _Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.embedding = nn.Linear(cin, cout)


class _Attn(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Linear(dim, D_FF))
        self.conv2 = nn.Sequential(nn.GELU(), nn.Linear(D_FF, dim))


class _Block(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _Attn(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim)
        self.pool_layers = nn.ModuleList(
            [nn.Linear(WINDOW[0] * WINDOW[1], 1)])


class _SPyNetLevel(nn.Module):
    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(
            _Wrap(ci, co, 7, 3) for ci, co in SPYNET_CHANNELS)


class _SPyNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(
            _SPyNetLevel() for _ in range(SPYNET_LEVELS))


class Generator(nn.Module):
    """The parameter tree of InpaintGenerator (variant 'base' or 'hq')."""

    def __init__(self, variant="base"):
        super().__init__()
        if variant not in ("base", "hq"):
            raise ValueError(f"variant {variant!r}")
        self.variant = variant
        c = CHANNEL // 2
        self.encoder = nn.Module()
        self.encoder.layers = nn.Sequential(*[
            m for ci, co, s, g in ENC_PLAN
            for m in (nn.Conv2d(ci, co, 3, s, 1, groups=g),
                      nn.LeakyReLU(0.2))])
        dec = []
        for i, (up, ci, co) in enumerate(DEC_PLAN):
            dec.append(_Wrap(ci, co) if up else nn.Conv2d(ci, co, 3,
                                                          padding=1))
            if i < len(DEC_PLAN) - 1:
                dec.append(nn.LeakyReLU(0.2))
        self.decoder = nn.Sequential(*dec)
        self.feat_prop_module = _FeatProp(c)
        self.ss = _Linear(c * 49, HIDDEN)
        self.sc = _Linear(HIDDEN, c * 49)
        if variant == "base":
            self.sc.bias = nn.Parameter(torch.empty(c, *OUTPUT_SIZE))
        else:
            self.sc.bias_conv = nn.Conv2d(c, c, 3, padding=1)
        self.transformer = nn.ModuleList(_Block(HIDDEN)
                                         for _ in range(DEPTHS))
        self.update_spynet = _SPyNet()


def param_shapes(variant):
    """[(name, shape)] of the variant's state dict, in its order."""
    with torch.device("meta"):
        g = Generator(variant)
    return [(k, tuple(v.shape)) for k, v in g.state_dict().items()]


# ---------------------------------------------------------------------------
# Products, in float32 or through a narrower type
# ---------------------------------------------------------------------------

class Ops:
    """Where every product of the reference goes. round_to None: float32
    operands; a float8 dtype: each operand scaled by its absolute maximum
    to the type's range, rounded to it, and scaled back (per-tensor fp8,
    as a float8 inference path computes), accumulated in float32."""

    def __init__(self, round_to=None):
        self.round_to = round_to

    def q(self, t):
        t = t.float()
        if self.round_to is None:
            return t
        amax = t.abs().amax()
        scale = torch.where(amax > 0, amax / torch.finfo(self.round_to).max,
                            torch.ones_like(amax))
        return (t / scale).to(self.round_to).float() * scale

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        """x (N, H, W, Cin), w OIHW -> (N, Ho, Wo, Cout)."""
        y = F.conv2d(self.q(x).permute(0, 3, 1, 2), self.q(w),
                     None if b is None else b.float(), stride=stride,
                     padding=padding, groups=groups)
        return y.permute(0, 2, 3, 1)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


# ---------------------------------------------------------------------------
# Resizes and warps (channel-last)
# ---------------------------------------------------------------------------

def resize(x, out_h, out_w, align_corners):
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def resize_quarter(x):
    h, w = x.shape[-3], x.shape[-2]
    return resize(x, int(math.floor(h * 0.25)), int(math.floor(w * 0.25)),
                  True)


def _abs(d):
    return torch.where(d >= 0, d, -d)


def bilinear_sample(x, py, px):
    """(B, H, W, C) sampled at (B, R) pixel positions -> (B, R, C) float32;
    corners outside the image contribute nothing (mmcv's DCN sampler)."""
    b, h, w, c = x.shape
    x = x.float()
    sy = torch.clamp(torch.floor(py), 0, h - 2)
    sx = torch.clamp(torch.floor(px), 0, w - 2)
    wy0 = torch.relu(1.0 - _abs(py - sy))
    wy1 = torch.relu(1.0 - _abs(py - (sy + 1.0)))
    wx0 = torch.relu(1.0 - _abs(px - sx))
    wx1 = torch.relu(1.0 - _abs(px - (sx + 1.0)))
    top = (sy * w + sx).long()
    xf = x.reshape(b, h * w, c)

    def corner(offset):
        return torch.gather(xf, 1, (top + offset)[..., None].expand(-1, -1, c))

    return (corner(0) * (wy0 * wx0)[..., None]
            + corner(1) * (wy0 * wx1)[..., None]
            + corner(w) * (wy1 * wx0)[..., None]
            + corner(w + 1) * (wy1 * wx1)[..., None])


def flow_warp(x, flow, padding_mode="zeros"):
    """Backward warp of (N, H, W, C) by a (N, H, W, 2) (dx, dy) flow."""
    n, h, w, c = x.shape
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    fx = gx + flow[..., 0].float()
    fy = gy + flow[..., 1].float()
    if padding_mode == "zeros":
        out = bilinear_sample(x, fy.reshape(n, h * w), fx.reshape(n, h * w))
        return out.reshape(n, h, w, c)
    grid = torch.stack([2.0 * fx / max(w - 1, 1) - 1.0,
                        2.0 * fy / max(h - 1, 1) - 1.0], -1)
    y = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
                      padding_mode=padding_mode, align_corners=True)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Encoder, decoder, SPyNet
# ---------------------------------------------------------------------------

def encode(g, ops, x):
    """(N, H, W, 3) in [-1, 1] -> (N, H/4, W/4, 128)."""
    out, x0 = x, None
    for i, (_, _, stride, groups) in enumerate(ENC_PLAN):
        if i == 4:
            x0 = out
        if i in ENC_FUSE_GROUPS:
            k = ENC_FUSE_GROUPS[i]
            n, h, w, _ = out.shape
            out = torch.cat([x0.reshape(n, h, w, k, -1),
                             out.reshape(n, h, w, k, -1)], -1).reshape(
                                 n, h, w, -1)
        conv = g.encoder.layers[2 * i]
        out = F.leaky_relu(ops.conv2d(out, conv.weight, conv.bias, stride,
                                      1, groups), 0.2)
    return out


def decode(g, ops, x):
    """(N, H/4, W/4, 128) -> (N, H, W, 3), before tanh."""
    convs = [m for m in g.decoder if not isinstance(m, nn.LeakyReLU)]
    for i, ((up, _, _), m) in enumerate(zip(DEC_PLAN, convs)):
        if up:
            x = resize(x, 2 * x.shape[-3], 2 * x.shape[-2], True)
            m = m.conv
        x = ops.conv2d(x, m.weight, m.bias, padding=1)
        if i < len(DEC_PLAN) - 1:
            x = F.leaky_relu(x, 0.2)
    return x


def spynet(g, ops, ref, supp):
    """Flow ref -> supp of (N, h, w, 3) frames in [0, 1]: (N, h, w, 2)."""
    net = g.update_spynet
    h, w = ref.shape[1], ref.shape[2]
    h_up, w_up = -(-h // 32) * 32, -(-w // 32) * 32
    mean = torch.tensor(SPYNET_MEAN, device=ref.device)
    std = torch.tensor(SPYNET_STD, device=ref.device)
    refs = [(resize(ref.float(), h_up, w_up, False) - mean) / std]
    supps = [(resize(supp.float(), h_up, w_up, False) - mean) / std]

    def pool(z):
        return F.avg_pool2d(z.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    for _ in range(SPYNET_LEVELS - 1):
        refs.append(pool(refs[-1]))
        supps.append(pool(supps[-1]))
    refs, supps = refs[::-1], supps[::-1]
    flow = refs[0].new_zeros((ref.shape[0], h_up // 32, w_up // 32, 2))
    for level in range(SPYNET_LEVELS):
        if level:
            flow = resize(flow, 2 * flow.shape[1], 2 * flow.shape[2],
                          True) * 2.0
        warped = flow_warp(supps[level], flow, "border")
        x = torch.cat([refs[level], warped, flow], -1)
        for i, m in enumerate(net.basic_module[level].basic_module):
            x = ops.conv2d(x, m.conv.weight, m.conv.bias, padding=3)
            if i < len(SPYNET_CHANNELS) - 1:
                x = torch.relu(x)
        flow = flow + x
    flow = resize(flow, h, w, False)
    return flow * torch.tensor([w / w_up, h / h_up], device=flow.device)


# ---------------------------------------------------------------------------
# Flow-guided deformable propagation
# ---------------------------------------------------------------------------

def deform_conv(ops, x, head, flow_1, flow_2, weight, bias):
    """Second-order DCNv2 from the raw offset head (reference
    feat_prop.py:35-58 and mmcv's modulated_deform_conv2d): x (N, H, W,
    2C), head (N, H, W, 27 G) -> (N, H, W, C)."""
    n, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    k, g = kh * kw, DEFORM_GROUPS
    res = MAX_RESIDUE * torch.tanh(head[..., : 2 * k * g].float())
    res = res.reshape(n, h, w, g, k, 2)
    half = (torch.arange(g, device=x.device) >= g // 2).float()
    half = half[None, None, None, :, None, None]
    f1 = flow_1.float().flip(-1)[:, :, :, None, None, :]
    f2 = flow_2.float().flip(-1)[:, :, :, None, None, :]
    off = res + f1 * (1.0 - half) + f2 * half           # (dy, dx)
    mask = torch.sigmoid(head[..., 2 * k * g:].float()).reshape(n, h, w, g, k)
    cg = cin // g
    xg = x.float().reshape(n, h, w, g, cg).permute(0, 3, 1, 2, 4)
    xg = xg.reshape(n * g, h, w, cg)
    taps = torch.arange(k, device=x.device)
    ky, kx = (taps // kw).float(), (taps % kw).float()
    f32 = dict(dtype=torch.float32, device=x.device)
    by = torch.arange(h, **f32)[:, None] - 1 + ky
    bx = torch.arange(w, **f32)[:, None] - 1 + kx
    py = by[None, :, None, None, :] + off[..., 0]
    px = bx[None, None, :, None, :] + off[..., 1]

    def per_group(p):
        return p.permute(0, 3, 4, 1, 2).reshape(n * g, k * h * w)

    cols = bilinear_sample(xg, per_group(py), per_group(px))
    cols = (cols.reshape(n, g, k, h, w, cg)
            * mask.permute(0, 3, 4, 1, 2)[..., None])
    w4 = weight.float().reshape(cout, g, cg, k)
    return ops.einsum("ngkyxc,ogck->nyxo", cols, w4) + bias.float()


def propagate(g, ops, x, flows_bwd_branch, flows_fwd_branch):
    """Second-order bidirectional propagation of one window's local
    features (reference feat_prop.py:60-140; the flow of step i is index
    i-1 / i-2 in both directions, as the released weights were trained).
    x (B, T, H, W, C); flows (B, T-1, H, W, 2). Returns fused + x."""
    mod = g.feat_prop_module
    b, t, h, w, c = x.shape
    zeros = x.new_zeros((b, h, w, c))
    feats = {}

    def backbone(d, cat, prop):
        seq = mod.backbone[f"{d}_"]
        r = F.leaky_relu(ops.conv2d(cat, seq[0].weight, seq[0].bias,
                                    padding=1), 0.1)
        return prop + ops.conv2d(r, seq[2].weight, seq[2].bias, padding=1)

    for d in ("backward", "forward"):
        align = mod.deform_align[f"{d}_"]
        convs = [m for m in align.conv_offset if isinstance(m, nn.Conv2d)]
        spatial = x.flip(1) if d == "backward" else x
        flows = flows_bwd_branch if d == "backward" else flows_fwd_branch
        cat0 = [spatial[:, 0], zeros]
        if d == "forward":
            cat0.insert(1, feats["backward"][0])
        outs = [backbone(d, torch.cat(cat0, -1), zeros)]
        prev1, prev2 = outs[0], zeros
        for i in range(1, t):
            cur = spatial[:, i]
            flow_n1 = flows[:, i - 1].float()
            if i > 1:
                feat_n2 = prev2
                f2 = flows[:, i - 2].float()
                flow_n2 = flow_n1 + flow_warp(f2, flow_n1)
            else:
                feat_n2 = torch.zeros_like(prev1)
                flow_n2 = torch.zeros_like(flow_n1)
            cond = torch.cat([flow_warp(prev1, flow_n1), cur,
                              flow_warp(feat_n2, flow_n2)], -1)
            head = torch.cat([cond, flow_n1, flow_n2], -1)
            for j, m in enumerate(convs):
                head = ops.conv2d(head, m.weight, m.bias, padding=1)
                if j < len(convs) - 1:
                    head = F.leaky_relu(head, 0.1)
            aligned = deform_conv(ops, torch.cat([prev1, feat_n2], -1), head,
                                  flow_n1, flow_n2, align.weight, align.bias)
            cat = [cur, aligned]
            if d == "forward":
                cat.insert(1, feats["backward"][i])
            out = backbone(d, torch.cat(cat, -1), aligned)
            prev1, prev2 = out, prev1
            outs.append(out)
        feats[d] = outs[::-1] if d == "backward" else outs
    cat = torch.cat([torch.stack(feats["backward"], 1),
                     torch.stack(feats["forward"], 1)], -1)
    fused = ops.conv2d(cat.reshape(b * t, h, w, 2 * c), mod.fusion.weight,
                       mod.fusion.bias)
    return fused.reshape(b, t, h, w, c) + x


# ---------------------------------------------------------------------------
# Soft split / comp, literal
# ---------------------------------------------------------------------------

def token_grid(size):
    (kh, kw), (sh, sw), (ph, pw) = T2T_KERNEL, T2T_STRIDE, T2T_PADDING
    return ((size[0] + 2 * ph - kh) // sh + 1,
            (size[1] + 2 * pw - kw) // sw + 1)


def _fold(p, size):
    return F.fold(p, size, T2T_KERNEL, padding=T2T_PADDING, stride=T2T_STRIDE)


def _unfold(x):
    return F.unfold(x, T2T_KERNEL, padding=T2T_PADDING, stride=T2T_STRIDE)


def soft_split(g, ops, x, b):
    """(B*T, H, W, C) -> (B, T, Lh, Lw, hidden): unfold, then Linear."""
    bt, h, w, c = x.shape
    lh, lw = token_grid((h, w))
    p = _unfold(x.permute(0, 3, 1, 2).float()).transpose(1, 2)
    tok = ops.linear(p, g.ss.embedding.weight, g.ss.embedding.bias)
    return tok.reshape(b, bt // b, lh, lw, -1)


def soft_comp(g, ops, tokens, size):
    """(B, T, Lh, Lw, hidden) -> (B*T, H, W, C): Linear, fold, then the
    bias map (base) or the 3x3 bias conv (HQ)."""
    b, t, lh, lw, hid = tokens.shape
    p = ops.linear(tokens.reshape(b * t, lh * lw, hid),
                   g.sc.embedding.weight, g.sc.embedding.bias)
    out = _fold(p.transpose(1, 2), size)
    if g.variant == "hq":
        conv = g.sc.bias_conv
        out = ops.conv2d(out.permute(0, 2, 3, 1), conv.weight, conv.bias,
                         padding=1)
        return out
    return (out + g.sc.bias.float()).permute(0, 2, 3, 1)


def fusion_feed_forward(mlp, ops, x, size):
    """F3N literal: fc1, overlap-mean fold, unfold, gelu, fc2."""
    b, n, c = x.shape
    fc1, fc2 = mlp.conv1[0], mlp.conv2[1]
    hid = ops.linear(x, fc1.weight, fc1.bias)
    lh, lw = token_grid(size)
    bt = b * (n // (lh * lw))
    p = hid.reshape(bt, lh * lw, -1).transpose(1, 2)
    cnt = _fold(torch.ones_like(p[:1, :1]).expand(1, 49, -1), size)
    y = _unfold(_fold(p, size) / cnt)
    y = F.gelu(y.transpose(1, 2).reshape(b, n, -1))
    return ops.linear(y, fc2.weight, fc2.bias)


# ---------------------------------------------------------------------------
# Focal window attention, the reference's key sets
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def key_table(h, w):
    """Per window of an (h, w) token grid: the sources of its keys in
    [fine tokens (h*w) | pooled window tokens | one zero slot] and their
    biases. Keys: the window's own tokens, the out-of-window tokens of the
    four rolled copies (torch.roll by (+-eh, +-ew), reference
    valid_ind_rolled), and the (2 eh + 1) x (2 ew + 1) unfolded pooled
    window tokens, -100 where they fall outside the pooled grid.
    Returns (idx (nwin, S) int64, bias (nwin, S) float32)."""
    wh, ww = WINDOW
    eh, ew = wh // 2, ww // 2
    nwy, nwx = h // wh, w // ww
    masks = []
    for fy, fx in ((1, 1), (1, 0), (0, 1), (0, 0)):
        m = np.ones((wh, ww), np.bool_)
        m[slice(None, -eh) if fy else slice(eh, None),
          slice(None, -ew) if fx else slice(ew, None)] = False
        masks.append(m)
    rolled = np.nonzero(np.stack(masks).reshape(-1))[0]
    shifts = ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew))
    pkh, pkw = 2 * eh + 1, 2 * ew + 1
    zero = h * w + nwy * nwx
    idx, bias = [], []
    for wy in range(nwy):
        for wx in range(nwx):
            slots = [(wy * wh + ry) * w + wx * ww + rx
                     for ry in range(wh) for rx in range(ww)]
            for v in rolled:
                r, rem = divmod(int(v), wh * ww)
                ry, rx = divmod(rem, ww)
                sy, sx = shifts[r]
                slots.append(((wy * wh + ry - sy) % h) * w
                             + (wx * ww + rx - sx) % w)
            row_bias = [0.0] * len(slots)
            for ay in range(pkh):
                for ax in range(pkw):
                    py, px = wy + ay - eh, wx + ax - ew
                    inside = 0 <= py < nwy and 0 <= px < nwx
                    slots.append(h * w + py * nwx + px if inside else zero)
                    row_bias.append(0.0 if inside else -100.0)
            idx.append(slots)
            bias.append(row_bias)
    return (np.asarray(idx, np.int64), np.asarray(bias, np.float32))


def _pool(block, ops, x):
    """Each (wh, ww) window to one token by the block's pooling Linear:
    (B, T, H, W, C) -> (B, nWh, nWw, T, C); H, W tile exactly here."""
    b, t, h, w, c = x.shape
    wh, ww = WINDOW
    xw = x.reshape(b, t, h // wh, wh, w // ww, ww, c)
    pool = block.pool_layers[0]
    pooled = ops.einsum("btiyjxc,yx->btijc", xw, pool.weight.reshape(wh, ww))
    return (pooled + pool.bias.float()).permute(0, 2, 3, 1, 4)


WINDOW_CHUNK = 16


def window_attention(attn, ops, x, pooled):
    """x (B, T, H, W, C) normalized tokens, pooled (B, nWh, nWw, T, C).
    Returns (B, T, H, W, C) after proj."""
    b, t, h, w, c = x.shape
    wh, ww = WINDOW
    heads, hd = NUM_HEADS, c // NUM_HEADS
    nwy, nwx = h // wh, w // ww
    qkv = ops.linear(x, attn.qkv.weight, attn.qkv.bias)
    qkv = qkv.reshape(b, t, h, w, 3, heads, hd).permute(4, 0, 5, 1, 2, 3, 6)
    pq = ops.linear(pooled, attn.qkv.weight, attn.qkv.bias)
    pq = pq.reshape(b, nwy, nwx, t, 3, heads, hd).permute(4, 0, 5, 3, 1, 2, 6)
    idx, kbias = key_table(h, w)
    idx = torch.as_tensor(idx, device=x.device)
    kbias = torch.as_tensor(kbias, device=x.device)

    def sources(z, zp):                         # (B, heads, T, h*w+nwin+1, hd)
        return torch.cat([z.reshape(b, heads, t, h * w, hd),
                          zp.reshape(b, heads, t, nwy * nwx, hd),
                          z.new_zeros((b, heads, t, 1, hd))], 3)

    ks, vs = sources(qkv[1], pq[1]), sources(qkv[2], pq[2])
    q = (qkv[0] * hd ** -0.5).reshape(b, heads, t, nwy, wh, nwx, ww, hd)
    q = q.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, heads, nwy * nwx,
                                                 t * wh * ww, hd)
    outs = []
    for s in range(0, nwy * nwx, WINDOW_CHUNK):
        sl = slice(s, s + WINDOW_CHUNK)
        n = idx[sl].shape[0]
        kk = ks[:, :, :, idx[sl]].permute(0, 1, 3, 2, 4, 5).reshape(
            b, heads, n, -1, hd)
        vv = vs[:, :, :, idx[sl]].permute(0, 1, 3, 2, 4, 5).reshape(
            b, heads, n, -1, hd)
        bias = kbias[sl][:, None, :].expand(n, t, -1).reshape(n, -1)
        sc = ops.einsum("bhwqd,bhwkd->bhwqk", q[:, :, sl], kk)
        p = torch.softmax(sc + bias[None, None, :, None, :], -1)
        outs.append(ops.einsum("bhwqk,bhwkd->bhwqd", p, vv))
    o = torch.cat(outs, 2)                      # (B, heads, nwin, nq, hd)
    o = o.permute(0, 2, 3, 1, 4).reshape(b, nwy, nwx, t, wh, ww, c)
    o = ops.linear(o, attn.proj.weight, attn.proj.bias)
    return o.permute(0, 3, 1, 4, 2, 5, 6).reshape(b, t, h, w, c)


def transformer_block(block, ops, x, size):
    b, t, h, w, c = x.shape
    xn = F.layer_norm(x, (c,), block.norm1.weight, block.norm1.bias)
    x = x + window_attention(block.attn, ops, xn, _pool(block, ops, xn))
    y = F.layer_norm(x, (c,), block.norm2.weight, block.norm2.bias)
    y = fusion_feed_forward(block.mlp, ops, y.reshape(b, t * h * w, c), size)
    return x + y.reshape(b, t, h, w, c)


# ---------------------------------------------------------------------------
# One window
# ---------------------------------------------------------------------------

def window_forward(g, ops, feat, flows_bwd_branch, flows_fwd_branch, n_local,
                   n_out=None):
    """One window from its encoded frames (1, T, H/4, W/4, C), local
    frames first, and its local frames' pair flows: propagation, soft
    split, 8 blocks, soft comp, residual and decode of the first n_out
    frames (default the local ones, all that the protocol keeps).
    Returns (n_out, H, W, 3) tanh output in [-1, 1]."""
    b, t, hq, wq, c = feat.shape
    n_out = n_local if n_out is None else n_out
    local = propagate(g, ops, feat[:, :n_local], flows_bwd_branch,
                      flows_fwd_branch)
    enc = torch.cat([local, feat[:, n_local:]], 1)
    tok = soft_split(g, ops, enc.reshape(b * t, hq, wq, c), b)
    for block in g.transformer:
        tok = transformer_block(block, ops, tok, (hq, wq))
    trans = soft_comp(g, ops, tok[:, :n_out], (hq, wq))
    out = enc[:, :n_out].reshape(b * n_out, hq, wq, c) + trans
    return torch.tanh(decode(g, ops, out))
