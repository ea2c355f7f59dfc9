"""ProPainter's inpainting generator (Zhou et al., ICCV 2023;
sczhou/ProPainter model/propainter.py InpaintGenerator), channel-last,
and its non-learned image propagation.

ProPainter keeps E2FGVI's frame of reference (the encoder with a 5-channel
input, the decoder, soft split / soft comp 7x7/3/3 with HQ's 3x3 bias conv,
F3N at d_ff 1960, hidden 512, 8 blocks of 4 heads in (5, 9) windows) and
changes three things:

- propagation in two domains over RAFT's flows (models/raft.py): the
  image propagation (`image_propagation`: nearest warps, a
  forward-backward consistency check, the "updated masks") over every
  frame, then the first-order feature propagation (`feature_propagation`:
  K1 at 8 channels a group, 16 groups, residual magnitude 3) over each
  window's local frames;
- the mask-guided sparse transformer: a window that the local frames'
  masks touch ("flagged") attends from all T frames to its own, the four
  rolled and the 180 pooled (depthwise 4x4/4 conv) keys of every second
  frame (`T_ind`, alternating by block); every other window attends only
  inside its own frame (45 keys). Which windows are flagged depends on
  the masks, which the host holds before any window runs
  (`window_flags`), so the pipeline hands each window batch its flagged
  and unflagged rows as index tensors (`SparseRows`) made once a video:
  no block and no batch waits for the device to learn its row counts.
  Flagged rows run on K3 (kernels/focal_attention.py) over key panels
  gathered through a deduplicated key table; unflagged rows on SDPA.
- the encoder takes (frame, mask, updated mask).

Parameter names are the released ProPainter.pth's.
"""

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels.deform import (conv_operands, flow_warp,
                                             modulated_deform_conv2d_head)
from e2fgvi_tpu_torch.kernels.focal_attention import focal_attention
from e2fgvi_tpu_torch.models import e2fgvi, feat_prop, tfocal
from e2fgvi_tpu_torch.ops.convs import layer_norm, linear
from e2fgvi_tpu_torch.ops.resize import resize_bilinear

CHANNEL = 128
HIDDEN = 512
DEPTHS = 8
NUM_HEADS = 4
WINDOW = (5, 9)
POOL = (4, 4)
T_DILATION = 2
DEFORM_GROUPS = 16
MAX_RESIDUE = 3.0
# the rolled keys' expansion, ((5 + 1) // 2, (9 + 1) // 2)
EXPAND = tuple((s + 1) // 2 for s in WINDOW)
MASK_THRESHOLD = 0.1
# ProPainter's inference_propainter.py: image propagation over sub-videos
# of 80 frames with 10 frames of context on each side
SUBVIDEO = 80
SUBVIDEO_PAD = 10


# ---------------------------------------------------------------------------
# Modules (parameter names follow the released checkpoint)
# ---------------------------------------------------------------------------

class DeformableAlignment(nn.Module):
    """DCNv2 weight (128, 128, 3, 3) and its offset head on [cur, warped,
    flow, valid, masks] (261 channels)."""

    def __init__(self, c=CHANNEL, groups=DEFORM_GROUPS):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c, c, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(2 * c + 2 + 1 + 2, c, 3, padding=1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, 27 * groups, 3, padding=1))


def _pair(c_in, c):
    return nn.Sequential(nn.Conv2d(c_in, c, 3, padding=1), nn.LeakyReLU(0.2),
                         nn.Conv2d(c, c, 3, padding=1))


class BidirectionalPropagation(nn.Module):
    def __init__(self, c=CHANNEL):
        super().__init__()
        dirs = ("backward_1", "forward_1")
        self.deform_align = nn.ModuleDict(
            {d: DeformableAlignment(c) for d in dirs})
        self.backbone = nn.ModuleDict({d: _pair(2 * c + 2, c) for d in dirs})
        self.fuse = _pair(2 * c + 2, c)


class SoftComp(nn.Module):
    def __init__(self, c=CHANNEL, hidden=HIDDEN):
        super().__init__()
        self.embedding = nn.Linear(hidden, c * 49)
        self.bias_conv = nn.Conv2d(c, c, 3, padding=1)


class SparseWindowAttention(nn.Module):
    def __init__(self, dim=HIDDEN):
        super().__init__()
        self.key = nn.Linear(dim, dim)
        self.query = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.pool_layer = nn.Conv2d(dim, dim, POOL, stride=POOL, groups=dim)


class FusionFeedForward(nn.Module):
    """ProPainter's F3N: fc1, fc2 (GELU, Linear); conv1 and conv2 name them
    for tfocal.fusion_feed_forward."""

    def __init__(self, dim=HIDDEN, d_ff=1960):
        super().__init__()
        self.fc1 = nn.Sequential(nn.Linear(dim, d_ff))
        self.fc2 = nn.Sequential(nn.GELU(), nn.Linear(d_ff, dim))

    @property
    def conv1(self):
        return self.fc1

    @property
    def conv2(self):
        return self.fc2


class TemporalSparseTransformer(nn.Module):
    def __init__(self, dim=HIDDEN):
        super().__init__()
        self.attention = SparseWindowAttention(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = FusionFeedForward(dim)


class TemporalSparseTransformerBlock(nn.Module):
    def __init__(self, dim=HIDDEN, depths=DEPTHS):
        super().__init__()
        self.transformer = nn.Sequential(
            *[TemporalSparseTransformer(dim) for _ in range(depths)])


class Generator(nn.Module):
    """InpaintGenerator's parameter tree; the forward is window_stage."""

    family = "propainter"

    def __init__(self):
        super().__init__()
        self.encoder = e2fgvi.Encoder(in_channels=5)
        dec = []
        for i, (up, cin, cout) in enumerate(e2fgvi._DEC_PLAN):
            dec.append(e2fgvi.Deconv(cin, cout) if up
                       else nn.Conv2d(cin, cout, 3, padding=1))
            if i < len(e2fgvi._DEC_PLAN) - 1:
                dec.append(nn.LeakyReLU(0.2))
        self.decoder = nn.Sequential(*dec)
        self.ss = tfocal.SoftSplit(CHANNEL, HIDDEN)
        self.sc = SoftComp(CHANNEL, HIDDEN)
        self.feat_prop_module = BidirectionalPropagation(CHANNEL)
        self.transformers = TemporalSparseTransformerBlock(HIDDEN, DEPTHS)

    decode = e2fgvi.Generator.decode


@torch.no_grad()
def init_weights(model, gen: torch.Generator):
    """Random init for a smoke run (a Generator or a raft.RAFT): N(0, 0.02)
    convs and linears, zero biases, identity norms, mean window pooling."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
            m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, SparseWindowAttention):
            m.pool_layer.weight.fill_(1.0 / (POOL[0] * POOL[1]))
    return model


# ---------------------------------------------------------------------------
# Warps and the consistency check
# ---------------------------------------------------------------------------

def warp_nearest(x, flow):
    """ProPainter's flow_warp(..., 'nearest'): F.grid_sample on the grid
    normalized with align_corners=True, zeros outside. (N, H, W, C),
    (N, H, W, 2) (dx, dy) -> (N, H, W, C) float32."""
    n, h, w, _ = x.shape
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    grid = torch.stack([2.0 * (gx + flow[..., 0]) / max(w - 1, 1) - 1.0,
                        2.0 * (gy + flow[..., 1]) / max(h - 1, 1) - 1.0], -1)
    y = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid, mode="nearest",
                      padding_mode="zeros", align_corners=True)
    return y.permute(0, 2, 3, 1)


def fb_valid(flow_f, warped_b):
    """fbConsistencyCheck given warp(b, f): |f + wb|^2 < 0.01 (|f|^2 +
    |wb|^2) + 0.5, as float32 (N, H, W, 1)."""
    diff = ((flow_f + warped_b) ** 2).sum(-1, keepdim=True)
    mag = (flow_f ** 2).sum(-1, keepdim=True) + (warped_b ** 2).sum(
        -1, keepdim=True)
    return (diff < 0.01 * mag + 0.5).float()


def fb_check(flow_f, flow_b):
    """fbConsistencyCheck(f, b) of (N, H, W, 2) float32 flows: bilinear
    warp of b by f (K2 on the card)."""
    return fb_valid(flow_f, flow_warp(flow_b.float(), flow_f.float()))


def _binary(m):
    return (m > MASK_THRESHOLD).float()


# ---------------------------------------------------------------------------
# Image propagation (no learned parts)
# ---------------------------------------------------------------------------

def image_propagation(frames, flows_f, flows_b, masks):
    """BidirectionalPropagation(3, learnable=False) over one (sub-)video.

    frames: (T, H, W, 3) masked frames; flows_f / flows_b: (T-1, H, W, 2)
    float32 forward (i -> i+1) and backward (i+1 -> i) flows; masks:
    (T, H, W, 1) {0, 1}. Returns the forward pass's (frames, masks), the
    latter the updated masks, both float32."""
    t = frames.shape[0]
    feats = [frames[i: i + 1].float() for i in range(t)]
    mks = [masks[i: i + 1].float() for i in range(t)]
    for direction in ("backward", "forward"):
        order = range(t - 1, -1, -1) if direction == "backward" else range(t)
        out_f, out_m = [None] * t, [None] * t
        prop = mprop = None
        for i, idx in enumerate(order):
            cur, mcur = feats[idx], mks[idx]
            if i == 0:
                prop, mprop = cur, mcur
            else:
                j = idx if direction == "backward" else idx - 1
                prop_flows, check_flows = ((flows_f, flows_b)
                                           if direction == "backward"
                                           else (flows_b, flows_f))
                fp = prop_flows[j: j + 1].float()
                fc = check_flows[j: j + 1]
                # the check's flow and the propagated mask in one warp
                wb = flow_warp(torch.cat([fc.float(), mprop], -1), fp)
                valid = fb_valid(fp, wb[..., :2])
                mvalid = _binary(wb[..., 2:])
                union = _binary(mcur * valid * (1 - mvalid))
                prop = union * warp_nearest(prop, fp) + (1 - union) * cur
                mprop = _binary(mcur * (1 - valid * (1 - mvalid)))
            out_f[idx], out_m[idx] = prop, mprop
        feats, mks = out_f, out_m
    return torch.cat(feats), torch.cat(mks)


def subvideo_spans(length, sub=SUBVIDEO, pad=SUBVIDEO_PAD):
    """[(s, e, keep_s, keep_e)]: image propagation runs over frames
    [s, e) and keeps [keep_s, keep_e), inference_propainter.py's
    sub-videos (one span when the video is no longer than `sub`)."""
    if length <= sub:
        return [(0, length, 0, length)]
    out = []
    for f in range(0, length, sub):
        out.append((max(0, f - pad), min(length, f + sub + pad), f,
                    min(length, f + sub)))
    return out


# ---------------------------------------------------------------------------
# Feature propagation
# ---------------------------------------------------------------------------

def _pair_forward(seq, x, residual=None):
    return feat_prop.conv3x3(
        feat_prop.conv3x3(x, seq[0], negative_slope=0.2), seq[2],
        residual=residual)


def feature_propagation(module, x, flows_f, flows_b, masks, valid_len=None):
    """BidirectionalPropagation(128, learnable=True), first order.

    x: (B, L, h, w, C) local features; flows_f / flows_b: (B, L-1, h, w, 2)
    float32 quarter-res forward and backward flows; masks: (B, L, h, w, 2)
    (mask in, updated mask) of x's dtype. valid_len: optional (B,) real
    frame counts of end-padded windows: the backward pass meets the
    padding first and starts afresh at each element's last real frame.
    Returns fuse([backward, forward, masks]) + x."""
    b, t, h, w, c = x.shape
    dt = x.dtype
    first_real = None if valid_len is None else (t - valid_len).long()
    inputs = [x[:, i] for i in range(t)]
    outs = {}
    for direction in ("backward", "forward"):
        key = f"{direction}_1"
        align = module.deform_align[key]
        operands = (None if x.device.type == "cpu" else
                    conv_operands(align.weight, align.bias, dt,
                                  DEFORM_GROUPS))
        offset_convs = [m for m in align.conv_offset
                        if isinstance(m, nn.Conv2d)]
        order = range(t - 1, -1, -1) if direction == "backward" else range(t)
        res = [None] * t
        prop = None
        for i, idx in enumerate(order):
            cur, mcur = inputs[idx], masks[:, idx]
            if i == 0:
                prop = cur
            else:
                j = idx if direction == "backward" else idx - 1
                fp = (flows_f if direction == "backward" else flows_b)[:, j]
                fc = (flows_b if direction == "backward" else flows_f)[:, j]
                fp = fp.float()
                valid = fb_check(fp, fc)
                warped = flow_warp(prop, fp)
                feat = torch.cat([cur, warped, fp.to(dt), valid.to(dt), mcur],
                                 -1)
                for k, conv in enumerate(offset_convs):
                    feat = feat_prop.conv3x3(
                        feat, conv, negative_slope=0.1 if k < 3 else None)
                aligned = modulated_deform_conv2d_head(
                    prop, feat, fp, fp, align.weight, align.bias,
                    max_residue=MAX_RESIDUE, operands=operands)
                if first_real is not None and direction == "backward":
                    # each element's last real frame starts the pass
                    first = (first_real == i)[:, None, None, None]
                    aligned = torch.where(first, cur, aligned)
                prop = aligned
            prop = _pair_forward(module.backbone[key],
                                 torch.cat([cur, prop, mcur], -1),
                                 residual=prop)
            res[idx] = prop
        outs[direction] = res
        inputs = res
    fb = torch.stack(outs["backward"], 1)
    ff = torch.stack(outs["forward"], 1)
    cat = torch.cat([fb, ff, masks], -1).reshape(b * t, h, w, 2 * c + 2)
    out = _pair_forward(module.fuse, cat, residual=x.reshape(b * t, h, w, c))
    return out.reshape(b, t, h, w, c)


# ---------------------------------------------------------------------------
# Sparse window attention
# ---------------------------------------------------------------------------

def padded_grid(lh, lw):
    """The token grid padded to whole windows."""
    return (math.ceil(lh / WINDOW[0]) * WINDOW[0],
            math.ceil(lw / WINDOW[1]) * WINDOW[1])


def window_flags(masks_q, lh, lw):
    """Which windows each frame's mask touches: ProPainter's mask_pool_l
    (max-pool 7/3/3 of the quarter-res mask) and the window max.
    masks_q: (T, hq, wq) {0, 1} numpy, the nearest quarter-res masks.
    Returns (T, nwin) bool numpy."""
    m = torch.from_numpy(np.ascontiguousarray(masks_q, np.float32))[:, None]
    pooled = F.max_pool2d(m, tfocal.T2T_KERNEL, tfocal.T2T_STRIDE,
                          tfocal.T2T_PADDING)[:, 0]
    if pooled.shape[1:] != (lh, lw):
        raise ValueError(f"mask grid {tuple(pooled.shape[1:])} != tokens "
                         f"{(lh, lw)}")
    ph, pw = padded_grid(lh, lw)
    pooled = F.pad(pooled, (0, pw - lw, 0, ph - lh))
    t = pooled.shape[0]
    win = pooled.reshape(t, ph // WINDOW[0], WINDOW[0], pw // WINDOW[1],
                         WINDOW[1]).amax((2, 4))
    return (win.reshape(t, -1) > 0).numpy()


@lru_cache(maxsize=8)
def key_table(ph, pw):
    """Each window's keys of one frame in that frame's sources [fine
    tokens (ph*pw) | pooled tokens | one zero slot]: its own 45 tokens
    and the 148 rolled ones (torch.roll wrap-around) with identical slots
    collapsed into one of bias ln(count), then every pooled token.
    Returns (idx (nwin, S) int64, bias (nwin, S) float32, sources a
    frame), padded with the zero slot at -1e9."""
    idx, _ = tfocal._key_gather_idx(ph, pw, WINDOW[0], WINDOW[1], EXPAND[0],
                                    EXPAND[1], None)
    npool = (ph // POOL[0]) * (pw // POOL[1])
    nsrc = ph * pw + npool + 1
    rows = []
    for r in idx:
        uniq, counts = np.unique(r, return_counts=True)
        rows.append((np.concatenate([uniq, ph * pw + np.arange(npool)]),
                     np.concatenate([np.log(counts),
                                     np.zeros(npool)])))
    s = max(len(u) for u, _ in rows)
    out_i = np.full((len(rows), s), nsrc - 1, np.int64)
    out_b = np.full((len(rows), s), -1e9, np.float32)
    for i, (u, lb) in enumerate(rows):
        out_i[i, :len(u)] = u
        out_b[i, :len(u)] = lb
    return out_i, out_b, nsrc


@lru_cache(maxsize=8)
def _device_key_table(ph, pw, device):
    idx, bias, nsrc = key_table(ph, pw)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(bias, device=device), nsrc)


@dataclasses.dataclass
class SparseRows:
    """A window batch's attention rows (row = b * nwin + window), made on
    the host from the masks and uploaded with the video's other tables:
    flagged and frame rows, and each flagged row's key frames (padded
    positions) for blocks of even and odd index, with their validity."""
    flagged: torch.Tensor            # (R,) int64
    frame: torch.Tensor              # (U,) int64
    key_frames: tuple                # 2 x (R, F) int64
    key_valid: tuple                 # 2 x (R, F) bool


def key_frames(nv, nr, n_local, parity):
    """Padded positions of a window's key frames T_ind = arange(parity, T,
    2) over its real frames (nv locals, then nr references, which the
    batch's padding puts at n_local)."""
    pos = list(range(nv)) + list(range(n_local, n_local + nr))
    return pos[parity::T_DILATION]


def sparse_attention(attn, x, rows, parity, num_heads=NUM_HEADS):
    """SparseWindowAttention over (B, T, lh, lw, C) normalized tokens.

    The grid is zero-padded to whole windows (q, k, v of padding tokens
    are their biases), windows are (5, 9). rows: SparseRows. Flagged rows
    take every query of the window's T frames against the own, rolled
    and pooled keys of their key frames of `parity` (T_ind = arange(
    parity, T, 2)), on K3; frame rows take each
    frame's 45 queries against its own 45 keys, on SDPA. Returns the
    projected (B, T, lh, lw, C)."""
    b, t, lh, lw, c = x.shape
    wh, ww = WINDOW
    hd = c // num_heads
    ph, pw = padded_grid(lh, lw)
    xp = F.pad(x, (0, 0, 0, pw - lw, 0, ph - lh))
    nwy, nwx = ph // wh, pw // ww
    nwin = nwy * nwx
    wqkv = torch.cat([attn.query.weight, attn.key.weight, attn.value.weight])
    bqkv = torch.cat([attn.query.bias, attn.key.bias, attn.value.bias])
    qkv = linear(xp, wqkv, bqkv).reshape(b, t, ph, pw, 3, num_heads, hd)
    # (3, B*nwin, heads, T, 45, hd): ProPainter's window_partition order
    wins = qkv.reshape(b, t, nwy, wh, nwx, ww, 3, num_heads, hd).permute(
        6, 0, 2, 4, 7, 1, 3, 5, 8).reshape(3, b * nwin, num_heads, t,
                                           wh * ww, hd)
    out = x.new_empty((b * nwin, t * wh * ww, c))
    n_frame = rows.frame.shape[0]
    if n_frame:
        q, k, v = (wins[i].index_select(0, rows.frame).reshape(
            n_frame, num_heads * t, wh * ww, hd) for i in range(3))
        o = F.scaled_dot_product_attention(q, k, v)
        o = o.reshape(n_frame, num_heads, t * wh * ww, hd).permute(0, 2, 1, 3)
        out.index_copy_(0, rows.frame, o.reshape(n_frame, -1, c))
    n_flag = rows.flagged.shape[0]
    if n_flag:
        out.index_copy_(0, rows.flagged,
                        _flagged_attention(attn, xp, qkv, wins[0], rows,
                                           parity, num_heads))
    out = out.reshape(b, nwy, nwx, t, wh, ww, c).permute(
        0, 3, 1, 4, 2, 5, 6).reshape(b, t, ph, pw, c)[:, :, :lh, :lw]
    return linear(out, attn.proj.weight, attn.proj.bias)


def _flagged_attention(attn, xp, qkv, qwin, rows, parity, num_heads):
    """K3 over the flagged rows: (R, T*45, C)."""
    b, t, ph, pw, c = xp.shape
    hd = c // num_heads
    kf, kvalid = rows.key_frames[parity], rows.key_valid[parity]
    tab, tab_bias, nsrc = _device_key_table(ph, pw, xp.device)
    pool = attn.pool_layer
    px = F.conv2d(xp.reshape(b * t, ph, pw, c).permute(0, 3, 1, 2),
                  pool.weight.to(xp.dtype), pool.bias.to(xp.dtype),
                  stride=POOL, groups=c).permute(0, 2, 3, 1)
    wkv = torch.cat([attn.key.weight, attn.value.weight])
    bkv = torch.cat([attn.key.bias, attn.value.bias])
    pkv = linear(px, wkv, bkv).reshape(b, t, -1, 2, num_heads, hd)
    fine = qkv[..., 1:, :, :].reshape(b, t, ph * pw, 2, num_heads, hd)
    zero = pkv.new_zeros((b, t, 1, 2, num_heads, hd))
    # (2, B*heads, T*nsrc, hd): every frame's key sources
    src = torch.cat([fine, pkv, zero], 2).permute(3, 0, 4, 1, 2, 5).reshape(
        2, b * num_heads, t * nsrc, hd)
    nwin = (ph // WINDOW[0]) * (pw // WINDOW[1])
    r, nf = kf.shape
    win = rows.flagged % nwin
    bat = rows.flagged // nwin
    s = tab.shape[1]
    # (R, F*S) offsets in a (b, head)'s sources, then in all of them
    rel = (kf[:, :, None] * nsrc + tab[win][:, None, :]).reshape(r, nf * s)
    heads = torch.arange(num_heads, device=xp.device)
    flat = ((bat[:, None] * num_heads + heads)[:, :, None] * (t * nsrc)
            + rel[:, None, :]).reshape(-1)
    k, v = (src[i].reshape(-1, hd).index_select(0, flat).reshape(
        r * num_heads, nf * s, hd) for i in range(2))
    bias = torch.where(kvalid[:, :, None], tab_bias[win][:, None, :],
                       torch.full((), -1e9, device=xp.device))
    q = qwin.index_select(0, rows.flagged) * hd ** -0.5
    q = q.reshape(r * num_heads, t * WINDOW[0] * WINDOW[1], hd)
    return focal_attention(q, k, v, bias.reshape(r, nf * s), r, num_heads)


def transformer_stack(blocks, x, output_size, rows):
    """The blocks in order; block i takes key frames of parity i % 2."""
    b, t, lh, lw, c = x.shape
    for i, block in enumerate(blocks.transformer):
        xn = layer_norm(x, block.norm1.weight, block.norm1.bias)
        x = x + sparse_attention(block.attention, xn, rows, i % T_DILATION)
        y = layer_norm(x, block.norm2.weight, block.norm2.bias)
        y = tfocal.fusion_feed_forward(block.mlp, y.reshape(b, t * lh * lw, c),
                                       t, output_size)
        x = x + y.reshape(b, t, lh, lw, c)
    return x


# ---------------------------------------------------------------------------
# The window stage
# ---------------------------------------------------------------------------

def window_stage(model, feat, flows, masks, num_local_frames, rows,
                 valid_local=None, mark=None):
    """Everything after the encoder for a batch of windows: feature
    propagation, soft split, the sparse transformer, soft comp, decode.

    feat: (B, T, h, w, C), local frames first; flows: (forward, backward)
    quarter-res flows, each (B, L-1, h, w, 2) float32; masks: (B, L, h, w,
    2) (mask in, updated mask) of the local frames, quarter-res nearest;
    rows: SparseRows; valid_local: optional (B,) real local counts; mark:
    optional callable, called with 'feat_prop', 'transformer', 'decode' as
    each ends. Returns (B, L, H, W, 3) tanh output of the local frames."""
    lt = num_local_frames
    b, t, hq, wq, c = feat.shape
    local = feature_propagation(model.feat_prop_module, feat[:, :lt],
                                flows[0], flows[1], masks.to(feat.dtype),
                                valid_local)
    enc = torch.cat([local, feat[:, lt:]], 1)
    if mark:
        mark("feat_prop")
    output_size = (hq, wq)
    tokens = tfocal.soft_split(model.ss, enc.reshape(b * t, hq, wq, c), b)
    tokens = transformer_stack(model.transformers, tokens, output_size, rows)
    trans = tfocal.soft_comp(model.sc, tokens[:, :lt], lt, output_size)
    out = enc[:, :lt] + trans.reshape(b, lt, hq, wq, c)
    if mark:
        mark("transformer")
    out = model.decode(out.reshape(b * lt, hq, wq, c))
    out = torch.tanh(out).reshape(b, lt, *out.shape[1:])
    if mark:
        mark("decode")
    return out


def encode(model, frames, masks, updated):
    """The encoder on (N, H, W, 3) frames in [-1, 1] with their masks and
    updated masks (N, H, W, 1), in the model's input dtype."""
    return model.encoder(torch.cat([frames, masks, updated], -1))


def downsample_flows(flows):
    """(N, H, W, 2) full-res flows -> quarter res, bilinear
    (align_corners=False) and divided by 4."""
    h, w = flows.shape[1:3]
    return resize_bilinear(flows.float(), h // 4, w // 4, False) / 4.0

