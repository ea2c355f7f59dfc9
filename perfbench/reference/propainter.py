"""ProPainter (Zhou et al., ICCV 2023) and its RAFT flows in plain PyTorch,
channel-first: the benchmark's reference for the propainter cell.

It imports nothing of the program under test and no kernel. It follows
the published code (sczhou/ProPainter model/propainter.py, model/modules/
sparse_transformer.py, RAFT/raft.py, RAFT/corr.py, inference_propainter.py)
statement by statement: each window runs alone at its own length, the
sparse attention loops over batch elements with the flagged windows found
by `nonzero`, every key of a flagged window is gathered (none is
deduplicated), the DCN samples with F.grid_sample, soft split / comp and
F3N are the literal unfold / Linear / fold chains. Its module tree has the
released checkpoints' parameter names, so one state dict loads into the
program and the reference alike.

Every product of the generator goes through `Ops` (reference/model.py):
float32, or with both operands rounded to a narrower type first (the
control). RAFT's products run in float32, or in TF32 where the caller
turns TF32 on (its control).
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import Ops

CHANNEL = 128
HIDDEN = 512
DEPTHS = 8
NUM_HEADS = 4
WINDOW = (5, 9)
POOL = (4, 4)
D_FF = 1960
DEFORM_GROUPS = 16
MAX_RESIDUE = 3.0
T2T = dict(kernel_size=(7, 7), stride=(3, 3), padding=(3, 3))
ENC_PLAN = [(5, 64, 2, 1), (64, 64, 1, 1), (64, 128, 2, 1),
            (128, 256, 1, 1), (256, 384, 1, 1), (640, 512, 1, 2),
            (768, 384, 1, 4), (640, 256, 1, 8), (512, 128, 1, 1)]
ENC_GROUPS = [1, 2, 4, 8, 1]
RAFT_ITERS = 20
SUBVIDEO, SUBVIDEO_PAD = 80, 10


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

class _Deconv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)


class _Align(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, c, 3, 3))
        self.bias = nn.Parameter(torch.empty(c))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(2 * c + 5, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, 27 * DEFORM_GROUPS, 3, 1, 1))


def _seq(cin, c):
    return nn.Sequential(nn.Conv2d(cin, c, 3, 1, 1), nn.LeakyReLU(0.2),
                         nn.Conv2d(c, c, 3, 1, 1))


class _Prop(nn.Module):
    def __init__(self, c):
        super().__init__()
        mods = ("backward_1", "forward_1")
        self.deform_align = nn.ModuleDict({m: _Align(c) for m in mods})
        self.backbone = nn.ModuleDict({m: _seq(2 * c + 2, c) for m in mods})
        self.fuse = _seq(2 * c + 2, c)


class _Emb(nn.Module):
    def __init__(self, cin, cout, bias_conv=False):
        super().__init__()
        self.embedding = nn.Linear(cin, cout)
        if bias_conv:
            self.bias_conv = nn.Conv2d(CHANNEL, CHANNEL, 3, 1, 1)


class _Attn(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.key = nn.Linear(d, d)
        self.query = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.proj = nn.Linear(d, d)
        self.pool_layer = nn.Conv2d(d, d, POOL, POOL, groups=d)


class _Mlp(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc1 = nn.Sequential(nn.Linear(d, D_FF))
        self.fc2 = nn.Sequential(nn.GELU(), nn.Linear(D_FF, d))


class _Block(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.attention = _Attn(d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = _Mlp(d)


class _Blocks(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.transformer = nn.Sequential(*[_Block(d) for _ in range(DEPTHS)])


class Generator(nn.Module):
    """InpaintGenerator's parameter tree."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.layers = nn.Sequential(*[
            m for ci, co, s, g in ENC_PLAN
            for m in (nn.Conv2d(ci, co, 3, s, 1, groups=g),
                      nn.LeakyReLU(0.2))])
        self.decoder = nn.Sequential(
            _Deconv(CHANNEL, 128), nn.LeakyReLU(0.2),
            nn.Conv2d(128, 64, 3, 1, 1), nn.LeakyReLU(0.2),
            _Deconv(64, 64), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 3, 3, 1, 1))
        self.ss = _Emb(CHANNEL * 49, HIDDEN)
        self.sc = _Emb(HIDDEN, CHANNEL * 49, bias_conv=True)
        self.feat_prop_module = _Prop(CHANNEL)
        self.transformers = _Blocks(HIDDEN)


class _Res(nn.Module):
    def __init__(self, cin, cout, norm, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.relu = nn.ReLU()
        mk = (lambda: nn.BatchNorm2d(cout)) if norm == "batch" else \
            (lambda: nn.InstanceNorm2d(cout))
        self.norm1, self.norm2 = mk(), mk()
        self.downsample = None
        if stride != 1:
            self.norm3 = mk()
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class _Encoder(nn.Module):
    def __init__(self, out, norm):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(64) if norm == "batch" else \
            nn.InstanceNorm2d(64)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.relu1 = nn.ReLU()
        self.layer1 = nn.Sequential(_Res(64, 64, norm), _Res(64, 64, norm))
        self.layer2 = nn.Sequential(_Res(64, 96, norm, 2),
                                    _Res(96, 96, norm))
        self.layer3 = nn.Sequential(_Res(96, 128, norm, 2),
                                    _Res(128, 128, norm))
        self.conv2 = nn.Conv2d(128, out, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class _Motion(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(4 * 81, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(256, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class _GRU(nn.Module):
    def __init__(self, hid=128, inp=256):
        super().__init__()
        c = hid + inp
        self.convz1 = nn.Conv2d(c, hid, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hid, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hid, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hid, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hid, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hid, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        for cz, cr, cq in ((self.convz1, self.convr1, self.convq1),
                           (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(cz(hx))
            r = torch.sigmoid(cr(hx))
            q = torch.tanh(cq(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)


class _Update(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _Motion()
        self.gru = _GRU()
        self.flow_head = _Head()
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(256, 576, 1))


class RAFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = _Encoder(256, "instance")
        self.cnet = _Encoder(256, "batch")
        self.update_block = _Update()


def param_shapes():
    """{'generator': [(name, shape)], 'raft': [...]}, state-dict order."""
    with torch.device("meta"):
        return {"generator": [(k, tuple(v.shape)) for k, v in
                              Generator().state_dict().items()],
                "raft": [(k, tuple(v.shape)) for k, v in
                         RAFT().state_dict().items()]}


# ---------------------------------------------------------------------------
# RAFT (RAFT/raft.py, RAFT/corr.py: test mode)
# ---------------------------------------------------------------------------

def _bilinear_sampler(img, coords):
    h, w = img.shape[-2:]
    xg, yg = coords.split([1, 1], dim=-1)
    grid = torch.cat([2 * xg / max(w - 1, 1) - 1,
                      2 * yg / max(h - 1, 1) - 1], -1)
    return F.grid_sample(img, grid, align_corners=True)


def _corr_block(f1, f2, radius=4, levels=4):
    b, d, h, w = f1.shape
    corr = torch.matmul(f1.view(b, d, h * w).transpose(1, 2),
                        f2.view(b, d, h * w))
    corr = (corr / torch.sqrt(torch.tensor(d).float())).reshape(
        b * h * w, 1, h, w)
    pyr = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyr.append(corr)

    def lookup(coords):
        coords = coords.permute(0, 2, 3, 1)
        n, h1, w1, _ = coords.shape
        out = []
        for i in range(levels):
            d_ = torch.linspace(-radius, radius, 2 * radius + 1,
                                device=coords.device)
            delta = torch.stack(torch.meshgrid(d_, d_, indexing="ij"), -1)
            c = coords.reshape(n * h1 * w1, 1, 1, 2) / 2 ** i + delta.view(
                1, 2 * radius + 1, 2 * radius + 1, 2)
            out.append(_bilinear_sampler(pyr[i], c).view(n, h1, w1, -1))
        return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous().float()
    return lookup


def raft_flow(net, image1, image2, iters=RAFT_ITERS):
    """RAFT.forward(image1, image2, iters, test_mode=True)'s flow_up, on
    (N, 3, H, W) frames in [-1, 1]."""
    fmap1, fmap2 = net.fnet(torch.cat([image1, image2])).float().chunk(2)
    lookup = _corr_block(fmap1, fmap2)
    cnet = net.cnet(image1)
    h_, inp = torch.split(cnet, [128, 128], dim=1)
    h_, inp = torch.tanh(h_), torch.relu(inp)
    n, _, h8, w8 = fmap1.shape
    ys, xs = torch.meshgrid(torch.arange(h8, device=image1.device),
                            torch.arange(w8, device=image1.device),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], 0).float()[None].repeat(n, 1, 1, 1)
    coords1 = coords0.clone()
    ub = net.update_block
    for _ in range(iters):
        corr = lookup(coords1)
        flow = coords1 - coords0
        motion = ub.encoder(flow, corr)
        h_ = ub.gru(h_, torch.cat([inp, motion], 1))
        delta = ub.flow_head.conv2(F.relu(ub.flow_head.conv1(h_)))
        mask = 0.25 * ub.mask(h_)
        coords1 = coords1 + delta
    flow = coords1 - coords0
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h8, w8), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h8, w8)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h8, 8 * w8)


def video_flows(net, frames, iters=RAFT_ITERS, chunk=8):
    """Forward and backward flows of every adjacent pair: (T-1, 2, H, W)
    each, from (T, 3, H, W) frames in [-1, 1]."""
    fw, bw = [], []
    for s in range(0, frames.shape[0] - 1, chunk):
        a = frames[s: s + chunk][: frames.shape[0] - 1 - s]
        b = frames[s + 1: s + 1 + len(a)]
        fw.append(raft_flow(net, a, b, iters))
        bw.append(raft_flow(net, b, a, iters))
    return torch.cat(fw), torch.cat(bw)


# ---------------------------------------------------------------------------
# Warps, propagation
# ---------------------------------------------------------------------------

def flow_warp(x, flow, interpolation="bilinear"):
    """ProPainter's flow_warp: x (N, C, H, W), flow (N, H, W, 2)."""
    _, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device),
                            torch.arange(w, device=x.device), indexing="ij")
    grid = torch.stack((gx, gy), 2).float() + flow
    grid = torch.stack([2.0 * grid[..., 0] / max(w - 1, 1) - 1.0,
                        2.0 * grid[..., 1] / max(h - 1, 1) - 1.0], 3)
    return F.grid_sample(x, grid, mode=interpolation, padding_mode="zeros",
                         align_corners=True)


def fb_check(flow_fw, flow_bw, alpha1=0.01, alpha2=0.5):
    """fbConsistencyCheck: (N, 2, H, W) flows -> (N, 1, H, W)."""
    bw = flow_warp(flow_bw, flow_fw.permute(0, 2, 3, 1))
    diff = flow_fw + bw
    mag = (flow_fw ** 2).sum(1, keepdim=True) + (bw ** 2).sum(1, keepdim=True)
    return ((diff ** 2).sum(1, keepdim=True) < alpha1 * mag + alpha2).float()


def _binary(m, th=0.1):
    return (m > th).to(m)


def deform_conv(ops, x, offset, mask, weight, bias):
    """torchvision.ops.deform_conv2d (3x3, pad 1, offset groups from
    `offset`): each group's taps sampled by F.grid_sample (zeros outside,
    align_corners, the DCN sampler's rule), times the mask, contracted."""
    n, cin, h, w = x.shape
    g = offset.shape[1] // 18
    cg = cin // g
    off = offset.reshape(n, g, 9, 2, h, w)
    ys, xs = torch.meshgrid(torch.arange(h, device=x.device),
                            torch.arange(w, device=x.device), indexing="ij")
    cols = []
    for k in range(9):
        ky, kx = divmod(k, 3)
        py = ys[None, None] - 1 + ky + off[:, :, k, 0]
        px = xs[None, None] - 1 + kx + off[:, :, k, 1]
        grid = torch.stack([2 * px / max(w - 1, 1) - 1,
                            2 * py / max(h - 1, 1) - 1], -1)
        s = F.grid_sample(x.reshape(n * g, cg, h, w),
                          grid.view(n * g, h, w, 2),
                          align_corners=True).view(n, g, cg, h, w)
        cols.append(s * mask.reshape(n, g, 9, h, w)[:, :, k, None])
    cols = torch.stack(cols, 3)                       # (n, g, cg, 9, h, w)
    wt = weight.view(weight.shape[0], g, cg, 9)
    return ops.einsum("ngckhw,ogck->nohw", cols, wt) + bias.view(1, -1, 1, 1)


def _conv(ops, x, m, stride=1, padding=1, groups=1):
    y = ops.conv2d(x.permute(0, 2, 3, 1), m.weight, m.bias, stride, padding,
                   groups)
    return y.permute(0, 3, 1, 2).contiguous()


def _seq_fwd(ops, seq, x):
    return _conv(ops, F.leaky_relu(_conv(ops, x, seq[0]), 0.2), seq[2])


def propagation(ops, module, x, flows_forward, flows_backward, mask,
                learnable=True):
    """BidirectionalPropagation.forward: x (b, t, c, h, w), flows (b, t-1,
    2, h, w), mask (b, t, m, h, w). Returns (outputs, masks_f)."""
    b, t, c, h, w = x.shape
    feats = {"input": [x[:, i] for i in range(t)]}
    masks = {"input": [mask[:, i] for i in range(t)]}
    cache = ["input", "backward_1", "forward_1"]
    for p_i, name in enumerate(cache[1:]):
        feats[name], masks[name] = [], []
        if "backward" in name:
            frame_idx = list(range(t))[::-1]
            flow_idx = frame_idx
            for_prop, for_check = flows_forward, flows_backward
        else:
            frame_idx = list(range(t))
            flow_idx = list(range(-1, t - 1))
            for_prop, for_check = flows_backward, flows_forward
        for i, idx in enumerate(frame_idx):
            cur = feats[cache[p_i]][idx]
            mcur = masks[cache[p_i]][idx]
            if i == 0:
                prop, mprop = cur, mcur
            else:
                fp = for_prop[:, flow_idx[i]]
                fc = for_check[:, flow_idx[i]]
                valid = fb_check(fp, fc)
                warped = flow_warp(prop, fp.permute(0, 2, 3, 1),
                                   "bilinear" if learnable else "nearest")
                if learnable:
                    al = module.deform_align[name]
                    cond = torch.cat([cur, warped, fp, valid, mcur], 1)
                    out = cond
                    convs = [m for m in al.conv_offset
                             if isinstance(m, nn.Conv2d)]
                    for k, m in enumerate(convs):
                        out = _conv(ops, out, m)
                        if k < 3:
                            out = F.leaky_relu(out, 0.1)
                    o1, o2, msk = torch.chunk(out, 3, dim=1)
                    offset = MAX_RESIDUE * torch.tanh(torch.cat((o1, o2), 1))
                    offset = offset + fp.flip(1).repeat(
                        1, offset.size(1) // 2, 1, 1)
                    prop = deform_conv(ops, prop, offset, torch.sigmoid(msk),
                                       al.weight, al.bias)
                    mprop = mcur
                else:
                    mvalid = _binary(flow_warp(mprop,
                                               fp.permute(0, 2, 3, 1)))
                    union = _binary(mcur * valid * (1 - mvalid))
                    prop = union * warped + (1 - union) * cur
                    mprop = _binary(mcur * (1 - (valid * (1 - mvalid))))
            if learnable:
                prop = prop + _seq_fwd(ops, module.backbone[name],
                                       torch.cat([cur, prop, mcur], 1))
            feats[name].append(prop)
            masks[name].append(mprop)
        if "backward" in name:
            feats[name] = feats[name][::-1]
            masks[name] = masks[name][::-1]
    ob = torch.stack(feats["backward_1"], 1).reshape(-1, c, h, w)
    of = torch.stack(feats["forward_1"], 1).reshape(-1, c, h, w)
    if learnable:
        out = _seq_fwd(ops, module.fuse, torch.cat(
            [ob, of, mask.reshape(-1, 2, h, w)], 1)) + x.reshape(-1, c, h, w)
        return out.reshape(b, t, c, h, w), None
    return of.reshape(b, t, c, h, w), torch.stack(masks["forward_1"], 1)


# ---------------------------------------------------------------------------
# The generator (InpaintGenerator.forward, eval)
# ---------------------------------------------------------------------------

def encode(g, ops, x):
    """Encoder.forward on (bt, 5, H, W)."""
    bt = x.shape[0]
    out, x0 = x, None
    layers = [m for m in g.encoder.layers if isinstance(m, nn.Conv2d)]
    for i, m in enumerate(layers):
        li = 2 * i
        if li == 8:
            x0 = out
            _, _, h, w = x0.shape
        if li > 8:
            grp = ENC_GROUPS[(li - 8) // 2]
            out = torch.cat([x0.view(bt, grp, -1, h, w),
                             out.view(bt, grp, -1, h, w)], 2).view(
                                 bt, -1, h, w)
        out = F.leaky_relu(_conv(ops, out, m, m.stride[0], 1, m.groups), 0.2)
    return out


def decode(g, ops, x):
    for m in g.decoder:
        if isinstance(m, _Deconv):
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=True)
            x = _conv(ops, x, m.conv)
        elif isinstance(m, nn.Conv2d):
            x = _conv(ops, x, m)
        else:
            x = F.leaky_relu(x, 0.2)
    return x


def _lin(ops, x, m):
    shape = x.shape
    return ops.linear(x.reshape(-1, shape[-1]), m.weight, m.bias).reshape(
        *shape[:-1], -1)


def _window_partition(x, n_head):
    b, t, h, w, c = x.shape
    x = x.view(b, t, h // WINDOW[0], WINDOW[0], w // WINDOW[1], WINDOW[1],
               n_head, c // n_head)
    return x.permute(0, 2, 4, 6, 1, 3, 5, 7).contiguous()


def sparse_attention(ops, attn, x, mask, t_ind):
    """SparseWindowAttention.forward (eval)."""
    b, t, h, w, c = x.shape
    wh, ww = WINDOW
    ch = c // NUM_HEADS
    nwh, nww = math.ceil(h / wh), math.ceil(w / ww)
    new_h, new_w = nwh * wh, nww * ww
    pad_r, pad_b = new_w - w, new_h - h
    if pad_r > 0 or pad_b > 0:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, 0))
        mask = F.pad(mask, (0, 0, 0, pad_r, 0, pad_b, 0, 0))
    q, k, v = (_lin(ops, x, m) for m in (attn.query, attn.key, attn.value))
    shape = (b, nwh * nww, NUM_HEADS, t, wh * ww, ch)
    win_q = _window_partition(q, NUM_HEADS).view(*shape)
    win_k = _window_partition(k, NUM_HEADS).view(*shape)
    win_v = _window_partition(v, NUM_HEADS).view(*shape)
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    masks_r = []
    for ys, xs in (((None, -eh), (None, -ew)), ((None, -eh), (ew, None)),
                   ((eh, None), (None, -ew)), ((eh, None), (ew, None))):
        m_ = torch.ones(wh, ww)
        m_[slice(*ys), slice(*xs)] = 0
        masks_r.append(m_)
    valid_ind = torch.stack(masks_r, 0).flatten().nonzero().view(-1).to(
        x.device)
    rolled = []
    for sy, sx in ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew)):
        rolled.append(tuple(
            _window_partition(torch.roll(a, shifts=(sy, sx), dims=(2, 3)),
                              NUM_HEADS).view(*shape) for a in (k, v)))
    rk = torch.cat([r[0] for r in rolled], 4)[:, :, :, :, valid_ind]
    rv = torch.cat([r[1] for r in rolled], 4)[:, :, :, :, valid_ind]
    win_k = torch.cat((win_k, rk), 4)
    win_v = torch.cat((win_v, rv), 4)
    pool = attn.pool_layer
    px = ops.conv2d(x.reshape(b * t, new_h, new_w, c), pool.weight,
                    pool.bias, stride=POOL, groups=c)
    _, p_h, p_w, _ = px.shape
    px = px.reshape(b, t, p_h, p_w, c)
    for m, lst in ((attn.key, "k"), (attn.value, "v")):
        pk = _lin(ops, px, m).unsqueeze(1).repeat(1, nwh * nww, 1, 1, 1, 1)
        pk = pk.view(b, nwh * nww, t, p_h, p_w, NUM_HEADS, ch).permute(
            0, 1, 5, 2, 3, 4, 6).contiguous().view(
                b, nwh * nww, NUM_HEADS, t, p_h * p_w, ch)
        if lst == "k":
            win_k = torch.cat((win_k, pk), 4)
        else:
            win_v = torch.cat((win_v, pk), 4)
    out = torch.zeros_like(win_q)
    l_t = mask.size(1)
    mask = F.max_pool2d(mask.view(b * l_t, new_h, new_w), WINDOW, WINDOW)
    mask = mask.view(b, l_t, nwh * nww).sum(1)
    scale = 1.0 / math.sqrt(ch)
    for i in range(b):
        ind = mask[i].nonzero(as_tuple=False).view(-1)
        n_ = len(ind)
        if n_ > 0:
            qt = win_q[i, ind].view(n_, NUM_HEADS, t * wh * ww, ch)
            kt = win_k[i, ind][:, :, t_ind].reshape(n_, NUM_HEADS, -1, ch)
            vt = win_v[i, ind][:, :, t_ind].reshape(n_, NUM_HEADS, -1, ch)
            att = torch.softmax(ops.einsum("nhqd,nhkd->nhqk", qt, kt) * scale,
                                -1)
            out[i, ind] = ops.einsum("nhqk,nhkd->nhqd", att, vt).view(
                n_, NUM_HEADS, t, wh * ww, ch)
        und = (mask[i] == 0).nonzero(as_tuple=False).view(-1)
        qs = win_q[i, und]
        ks = win_k[i, und, :, :, :wh * ww]
        vs = win_v[i, und, :, :, :wh * ww]
        att = torch.softmax(
            ops.einsum("nhtqd,nhtkd->nhtqk", qs, ks) * scale, -1)
        out[i, und] = ops.einsum("nhtqk,nhtkd->nhtqd", att, vs)
    out = out.view(b, nwh, nww, NUM_HEADS, t, wh, ww, ch).permute(
        0, 4, 1, 5, 2, 6, 3, 7).contiguous().view(b, t, new_h, new_w, c)
    out = out[:, :, :h, :w]
    return _lin(ops, out, attn.proj), int(
        (mask > 0).sum().item())


def _fold_args(size):
    return dict(output_size=size, **T2T)


def f3n(ops, mlp, x, size):
    """FusionFeedForward.forward on (B, N, C)."""
    n_vecs = 1
    for i, d in enumerate(T2T["kernel_size"]):
        n_vecs *= int((size[i] + 2 * T2T["padding"][i] - (d - 1) - 1)
                      / T2T["stride"][i] + 1)
    x = _lin(ops, x, mlp.fc1[0])
    b, n, c = x.size()
    norm = x.new_ones(b, n, 49).view(-1, n_vecs, 49).permute(0, 2, 1)
    norm = F.fold(norm, **_fold_args(size))
    x = F.fold(x.view(-1, n_vecs, c).permute(0, 2, 1), **_fold_args(size))
    x = F.unfold(x / norm, **T2T).permute(0, 2, 1).contiguous().view(b, n, c)
    return _lin(ops, F.gelu(x), mlp.fc2[1])


def forward(g, ops, masked_frames, flows, masks_in, masks_updated, l_t):
    """InpaintGenerator.forward (eval): masked_frames (b, t, 3, H, W),
    flows (forward, backward) (b, l_t-1, 2, H, W) at full resolution,
    masks (b, t, 1, H, W). Returns (b*l_t, 3, H, W) after tanh and the
    flagged-window count summed over the blocks."""
    b, t, _, oh, ow = masked_frames.shape
    enc = encode(g, ops, torch.cat([masked_frames.view(b * t, 3, oh, ow),
                                    masks_in.view(b * t, 1, oh, ow),
                                    masks_updated.view(b * t, 1, oh, ow)], 1))
    _, c, h, w = enc.shape
    local = enc.view(b, t, c, h, w)[:, :l_t]
    ref = enc.view(b, t, c, h, w)[:, l_t:]
    ds = [F.interpolate(f.reshape(-1, 2, oh, ow), scale_factor=1 / 4,
                        mode="bilinear", align_corners=False).view(
                            b, l_t - 1, 2, h, w) / 4.0 for f in flows]
    ds_in = F.interpolate(masks_in.reshape(-1, 1, oh, ow), scale_factor=1 / 4,
                          mode="nearest").view(b, t, 1, h, w)
    ds_in_local = ds_in[:, :l_t]
    ds_up_local = F.interpolate(masks_updated[:, :l_t].reshape(-1, 1, oh, ow),
                                scale_factor=1 / 4, mode="nearest").view(
                                    b, l_t, 1, h, w)
    pool_l = F.max_pool2d(ds_in_local.view(-1, 1, h, w), **T2T)
    pool_l = pool_l.view(b, l_t, 1, *pool_l.shape[-2:])
    local, _ = propagation(ops, g.feat_prop_module, local, ds[0], ds[1],
                           torch.cat([ds_in_local, ds_up_local], 2))
    enc = torch.cat((local, ref), 1)
    f_h, f_w = (int((s + 6 - 6 - 1) / 3 + 1) for s in (h, w))
    feat = F.unfold(enc.view(-1, c, h, w), **T2T).permute(0, 2, 1)
    x = _lin(ops, feat, g.ss.embedding).view(b, -1, f_h, f_w, HIDDEN)
    pool_l = pool_l.permute(0, 1, 3, 4, 2).contiguous()
    flagged = 0
    tt = x.size(1)
    for i, blk in enumerate(g.transformers.transformer):
        t_ind = torch.arange(i % 2, tt, 2, device=x.device)
        y, n_ = sparse_attention(ops, blk.attention,
                                 F.layer_norm(x, (HIDDEN,), blk.norm1.weight,
                                              blk.norm1.bias), pool_l, t_ind)
        flagged += n_
        x = x + y
        y = F.layer_norm(x, (HIDDEN,), blk.norm2.weight, blk.norm2.bias)
        x = x + f3n(ops, blk.mlp, y.view(b, -1, HIDDEN), (h, w)).view(
            x.shape)
    tr = _lin(ops, x.view(b, -1, HIDDEN), g.sc.embedding)
    tr = F.fold(tr.view(b * t, -1, tr.shape[-1]).permute(0, 2, 1),
                **_fold_args((h, w)))
    tr = _conv(ops, tr, g.sc.bias_conv).view(b, t, c, h, w)
    enc = enc + tr
    out = torch.tanh(decode(g, ops, enc[:, :l_t].reshape(-1, c, h, w)))
    return out, flagged


# ---------------------------------------------------------------------------
# The protocol (inference_propainter.py)
# ---------------------------------------------------------------------------

def _ref_index(f, neighbors, length, ref_stride=10):
    return [i for i in range(0, length, ref_stride) if i not in neighbors]


def subvideos(length):
    if length <= SUBVIDEO:
        return [(0, length, 0, length)]
    return [(max(0, f - SUBVIDEO_PAD),
             min(length, f + SUBVIDEO + SUBVIDEO_PAD), f,
             min(length, f + SUBVIDEO)) for f in range(0, length, SUBVIDEO)]


def image_propagation(frames, flows, masks):
    """model.img_propagation over the sub-videos: frames (T, 3, H, W)
    masked, flows (forward, backward) (T-1, 2, H, W), masks (T, 1, H, W).
    Returns (prop frames, updated masks)."""
    t = frames.shape[0]
    pf, pm = [], []
    for s, e, ks, ke in subvideos(t):
        fl = (flows[0][s: e - 1][None], flows[1][s: e - 1][None])
        p, m = propagation(None, None, frames[s:e][None], fl[0], fl[1],
                           masks[s:e][None], learnable=False)
        pf.append(p[0, ks - s: ke - s])
        pm.append(m[0, ks - s: ke - s])
    return torch.cat(pf), torch.cat(pm)


@torch.no_grad()
def inpaint(g, net, frames, masks, orig, binary, out_dtype, device,
            precision=None, stride=5, ref_stride=10, iters=RAFT_ITERS):
    """Composited frames of one video as inference_propainter.py makes
    them (flow completion left out). frames / orig (T, H, W, 3) uint8,
    masks / binary (T, H, W, 1) {0, 1}; H, W multiples of 8.
    precision: None (float32), 'tf32' (the caller turns TF32 on), or a
    float8 type's name (the generator's products rounded to it).
    Returns ((T, H, W, 3) numpy of out_dtype, (flows_f, flows_b) (T-1,
    H, W, 2) float32 on the device, flagged windows over all blocks)."""
    ops = Ops(getattr(torch, precision) if precision and
              precision.startswith("float8") else None)
    t, h, w = frames.shape[:3]
    fr = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    fr = fr.permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
    mk = torch.from_numpy(np.ascontiguousarray(masks)).to(device)
    mk = mk.permute(0, 3, 1, 2).float()
    if t > 1:
        flows = video_flows(net, fr, iters)
    else:
        flows = (fr.new_zeros((0, 2, h, w)),) * 2
    masked = fr * (1 - mk)
    if t > 1:
        prop, upd = image_propagation(masked, flows, mk)
    else:
        prop, upd = masked, mk
    updated = fr * (1 - mk) + prop * mk
    orig_t = torch.from_numpy(np.ascontiguousarray(orig)).to(device)
    bm = torch.from_numpy(np.ascontiguousarray(binary[..., :1] != 0)).to(
        device)
    comp = [None] * t
    flagged = 0
    for f in range(0, t, stride):
        nb = list(range(max(0, f - stride), min(t, f + stride + 1)))
        refs = _ref_index(f, nb, t, ref_stride)
        ids = nb + refs
        fl = tuple(x[nb[:-1]][None] for x in flows)
        out, n_ = forward(g, ops, updated[ids][None], fl, mk[ids][None],
                          upd[ids][None], len(nb))
        flagged += n_
        pred = ((out + 1) / 2 * 255).clamp(0, 255).permute(0, 2, 3, 1)
        pred = pred.to(torch.uint8)
        for i, idx in enumerate(nb):
            img = torch.where(bm[idx], pred[i], orig_t[idx])
            comp[idx] = img if comp[idx] is None else \
                comp[idx].float() * 0.5 + img.float() * 0.5
    comp = torch.stack([c_.float() for c_ in comp])
    if np.dtype(out_dtype) == np.uint8:
        comp = comp.to(torch.uint8)
    flows = tuple(x.permute(0, 2, 3, 1) for x in flows)
    return comp.cpu().numpy(), flows, flagged
