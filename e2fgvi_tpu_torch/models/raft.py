"""RAFT optical flow (Teed & Deng, ECCV 2020), the "things" model that
ProPainter runs (sczhou/ProPainter RAFT/raft.py, 20 refinement iterations
at inference), channel-last and in float32.

  fnet, cnet: BasicEncoders to 1/8 resolution, 256 channels (instance
    norm without affine; batch norm in eval mode)
  context: net = tanh(cnet[:128]), inp = relu(cnet[128:])
  correlation: all pairs of the 1/8 grid, f1^T f2 / sqrt(256), and a
    pyramid of 2x2 average pools over the second frame's axes (4 levels)
  20 iterations: a 9x9 bilinear lookup around coords1 / 2^l on every
    level (324 channels), the motion encoder, the separable ConvGRU, the
    flow head; coords1 += delta
  convex 8x upsampling of coords1 - coords0 by the mask head

Parameter names are the released raft-things.pth's (without its
`module.` prefix). The frames go in as the inpainting generator takes
them, in [-1, 1], as ProPainter hands them over. Every product runs in
float32 with TF32 off (utils/env.py), as ProPainter keeps RAFT in full
precision under --fp16: on the card the iterations' convolutions run on
C (kernels/conv.py raft_conv, 3xTF32), the rest on cuBLAS in float32.
`video_flows` runs each frame's encoders once for the two pairs it
belongs to.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels import conv as kconv
from e2fgvi_tpu_torch.utils.timing import NO_SPANS

HIDDEN_DIM = 128
CONTEXT_DIM = 128
CORR_LEVELS = 4
CORR_RADIUS = 4
ITERS = 20
# flow fields (pair, direction) refined together: bounds the correlation
# pyramids live at once (216 MB a field at 848x480)
FIELD_CHUNK = 16


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, norm_fn, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm_fn = norm_fn
        if norm_fn == "batch":
            self.norm1 = nn.BatchNorm2d(cout)
            self.norm2 = nn.BatchNorm2d(cout)
            if stride != 1:
                self.norm3 = nn.BatchNorm2d(cout)
        else:
            self.norm1 = nn.InstanceNorm2d(cout)
            self.norm2 = nn.InstanceNorm2d(cout)
            if stride != 1:
                self.norm3 = nn.InstanceNorm2d(cout)
        self.stride = stride
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride), self.norm3)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=256, norm_fn="batch"):
        super().__init__()
        self.norm_fn = norm_fn
        self.norm1 = (nn.BatchNorm2d(64) if norm_fn == "batch"
                      else nn.InstanceNorm2d(64))
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for i, (cin, cout, stride) in enumerate(dims):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(cin, cout, norm_fn, stride),
                ResidualBlock(cout, cout, norm_fn, 1)))
        self.conv2 = nn.Conv2d(128, output_dim, 1)


class BasicMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = nn.Conv2d(planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        c = hidden_dim + input_dim
        for a in ("z", "r", "q"):
            setattr(self, f"conv{a}1", nn.Conv2d(c, hidden_dim, (1, 5),
                                                 padding=(0, 2)))
            setattr(self, f"conv{a}2", nn.Conv2d(c, hidden_dim, (5, 1),
                                                 padding=(2, 0)))


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(HIDDEN_DIM, 128 + HIDDEN_DIM)
        self.flow_head = FlowHead(HIDDEN_DIM, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 64 * 9, 1))


class RAFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HIDDEN_DIM + CONTEXT_DIM, "batch")
        self.update_block = BasicUpdateBlock()


# ---------------------------------------------------------------------------
# Forward, channel-last (N, H, W, C) float32
# ---------------------------------------------------------------------------

def conv_gemm(x, weight, bias, stride, padding):
    """A convolution as one GEMM: the (ky, kx, c) patches of the
    zero-padded channel-last x gathered into rows (a strided view, one
    copy), times the weight reordered to match. x (N, H, W, Cin); weight
    (Cout, Cin, kh, kw); padding (ph, pw). -> (N, Ho, Wo, Cout)."""
    n, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    ph, pw = padding
    ho = (h + 2 * ph - kh) // stride + 1
    wo = (w + 2 * pw - kw) // stride + 1
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    sn, sh, sw, sc = xp.stride()
    patches = xp.as_strided((n, ho, wo, kh, kw, cin),
                            (sn, sh * stride, sw * stride, sh, sw, sc))
    wm = weight.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    y = F.linear(patches.reshape(n * ho * wo, kh * kw * cin), wm, bias)
    return y.reshape(n, ho, wo, cout)


def _conv(x, conv, stride=1, padding=None):
    """The encoders' convolutions and convf1 (7x7 on 2 channels, too few
    for C's TMA rows), on every device one GEMM each (conv_gemm): on the
    card cuBLAS in float32, where cuDNN's float32 picks (TF32 off) take FFT
    paths at a fifth of that speed."""
    if padding is None:
        padding = tuple(k // 2 for k in conv.kernel_size)
    return conv_gemm(x, conv.weight, conv.bias, stride, padding)


def _norm(norm, x):
    """Instance norm without affine (per sample and channel over H, W), or
    batch norm with its running statistics."""
    if isinstance(norm, nn.BatchNorm2d):
        scale = norm.weight / torch.sqrt(norm.running_var + norm.eps)
        return x * scale + (norm.bias - norm.running_mean * scale)
    return F.instance_norm(x.permute(0, 3, 1, 2),
                           eps=norm.eps).permute(0, 2, 3, 1)


def _residual(block, x):
    y = F.relu(_norm(block.norm1, _conv(x, block.conv1, block.stride)))
    y = F.relu(_norm(block.norm2, _conv(y, block.conv2)))
    if block.stride != 1:
        x = _norm(block.norm3, _conv(x, block.downsample[0], block.stride))
    return F.relu(x + y)


def encode(enc, x):
    """BasicEncoder: (N, H, W, 3) -> (N, H/8, W/8, output_dim)."""
    x = F.relu(_norm(enc.norm1, _conv(x, enc.conv1, 2)))
    for layer in (enc.layer1, enc.layer2, enc.layer3):
        for block in layer:
            x = _residual(block, x)
    return _conv(x, enc.conv2)


def corr_pyramid(f1, f2):
    """The all-pairs volume of (N, h, w, D) feature maps and its pooled
    levels: CORR_LEVELS tensors (N*h*w, 1, h_l, w_l)."""
    n, h, w, d = f1.shape
    corr = torch.bmm(f1.reshape(n, h * w, d),
                     f2.reshape(n, h * w, d).transpose(1, 2))
    corr = (corr / d ** 0.5).reshape(n * h * w, 1, h, w)
    levels = [corr]
    for _ in range(CORR_LEVELS - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        levels.append(corr)
    return levels


def _lookup_deltas(device):
    """The 9x9 window's offsets in RAFT's order: entry (a, b) is
    (a - r, b - r) added to (x, y), meshgrid(dy, dx) stacked."""
    r = CORR_RADIUS
    d = torch.linspace(-r, r, 2 * r + 1, device=device)
    return torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)


def corr_lookup(levels, coords):
    """Bilinear samples (align_corners, zeros outside) of each level on
    the 9x9 window around coords / 2^l: (N, h, w, 2) (x, y) ->
    (N, h, w, 324), level-major, RAFT's channel order."""
    n, h, w, _ = coords.shape
    delta = _lookup_deltas(coords.device).view(1, 9, 9, 2)
    out = []
    for lvl, corr in enumerate(levels):
        hl, wl = corr.shape[-2:]
        pts = coords.reshape(n * h * w, 1, 1, 2) / 2 ** lvl + delta
        # max(.., 1): a level one cell wide, where RAFT divides by zero
        grid = torch.stack([2 * pts[..., 0] / max(wl - 1, 1) - 1,
                            2 * pts[..., 1] / max(hl - 1, 1) - 1], -1)
        s = F.grid_sample(corr, grid, align_corners=True)
        out.append(s.reshape(n, h, w, -1))
    return torch.cat(out, -1)


# The update block's state, one channel-last (N, h, w, 512) buffer a
# refine: the convolutions read and write channel ranges of it (C takes
# inputs and outputs at any pixel pitch) where RAFT concatenates
# [c, f], x = [inp, motion, flow], [net, x] and [r * net, x].
NET, INP, MOTION, FLOW, RNET = (slice(0, 128), slice(128, 256),
                                slice(256, 382), slice(382, 384),
                                slice(384, 512))
HX = slice(0, 384)      # [net, x]: the z and r convolutions' input
XR = slice(128, 512)    # [x, r * net]: the q convolutions' (inputs rotated)
STATE = 512


def update_operands(ub):
    """C's operands (kernels/conv.py conv_operands) of every convolution
    of the iterations and the mask head but convf1, made once a refine: the
    z and r convolutions of each GRU half stacked (Cout 256), the q
    convolutions' input channels rotated from [r * net, x] to the state's
    [x, r * net]."""
    me, g, fh = ub.encoder, ub.gru, ub.flow_head
    convs = {"convc1": me.convc1, "convc2": me.convc2, "convf2": me.convf2,
             "conv": me.conv, "fh1": fh.conv1, "fh2": fh.conv2,
             "mask0": ub.mask[0], "mask2": ub.mask[2]}
    ops = {k: kconv.conv_operands(m.weight, m.bias)
           for k, m in convs.items()}
    for i in (1, 2):
        z, r, q = (getattr(g, f"conv{a}{i}") for a in "zrq")
        ops[f"zr{i}"] = kconv.conv_operands(
            torch.cat([z.weight, r.weight]), torch.cat([z.bias, r.bias]))
        ops[f"q{i}"] = kconv.conv_operands(
            torch.cat([q.weight[:, HIDDEN_DIM:], q.weight[:, :HIDDEN_DIM]],
                      1), q.bias)
    return ops


def update(ub, ops, state, corr):
    """One iteration of BasicUpdateBlock without the mask head, on the
    state buffer (N, h, w, STATE) whose FLOW channels hold coords1 -
    coords0: the motion encoder writes MOTION, each GRU half r * net into
    RNET and the new hidden state over NET. ops: update_operands(ub).
    Returns the delta flow (N, h, w, 2)."""
    n, h, w, _ = state.shape
    c = kconv.raft_conv(corr, ops["convc1"], "relu")
    cf = state.new_empty((n, h, w, 256))                    # [c, f]
    kconv.raft_conv(c, ops["convc2"], "relu", out=cf[..., :192])
    f = F.relu(_conv(state[..., FLOW], ub.encoder.convf1))
    kconv.raft_conv(f, ops["convf2"], "relu", out=cf[..., 192:])
    kconv.raft_conv(cf, ops["conv"], "relu", out=state[..., MOTION])
    z = state.new_empty((n, h, w, HIDDEN_DIM))
    net = state[..., NET]
    for i in (1, 2):
        kconv.raft_conv(state[..., HX], ops[f"zr{i}"], "zr",
                        out=state[..., RNET], net=net, z=z)
        kconv.raft_conv(state[..., XR], ops[f"q{i}"], "gru", out=net,
                        net=net, z=z)
    return kconv.raft_conv(kconv.raft_conv(net, ops["fh1"], "relu"),
                           ops["fh2"])


def upsample_flow(flow, mask):
    """Convex 8x upsampling: (N, h, w, 2) flow, (N, h, w, 576) mask
    logits (channel k*64 + 8i + j) -> (N, 8h, 8w, 2)."""
    n, h, w, _ = flow.shape
    wts = torch.softmax(mask.reshape(n, h, w, 9, 8, 8), dim=3)
    fp = F.pad(8 * flow, (0, 0, 1, 1, 1, 1))
    nb = torch.stack([fp[:, ky: ky + h, kx: kx + w]
                      for ky in range(3) for kx in range(3)], 3)
    up = torch.einsum("nhwkij,nhwkc->nhiwjc", wts, nb)
    return up.reshape(n, 8 * h, 8 * w, 2)


def refine(raft, fmap1, fmap2, net, inp, iters=ITERS, spans=NO_SPANS):
    """The iterations of a batch of fields: the first frames' feature
    maps fmap1 and context (net, inp), the second frames' fmap2, each
    (N, h, w, C). Returns the (N, 8h, 8w, 2) (dx, dy) flows. spans: a
    utils.timing.StageTimer, which records the spans raft_corr (the
    volume and its pyramid) and raft_update (the iterations and the
    upsampling) and counts raft_iterations (one a field an iteration).
    The iterations' convolutions and the mask head run on C (kernels/
    conv.py raft_conv) but convf1; the encoders stay on conv_gemm."""
    spans.begin("raft_corr")
    levels = corr_pyramid(fmap1, fmap2)
    spans.mark("raft_corr", "raft_update")
    n, h, w, _ = fmap1.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=fmap1.device),
                            torch.arange(w, device=fmap1.device),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], -1).float()[None].expand(n, h, w, 2)
    coords1 = coords0
    ub = raft.update_block
    ops = update_operands(ub)
    state = net.new_empty((n, h, w, STATE))
    state[..., NET] = net
    state[..., INP] = inp
    for _ in range(iters):
        corr = corr_lookup(levels, coords1)
        state[..., FLOW] = coords1 - coords0
        coords1 = coords1 + update(ub, ops, state, corr)
    m = kconv.raft_conv(state[..., NET], ops["mask0"], "relu")
    mask = 0.25 * kconv.raft_conv(m, ops["mask2"])
    flow = upsample_flow(coords1 - coords0, mask)
    spans.count("raft_iterations", iters * n)
    spans.end("raft_update")
    return flow


def context(raft, frames):
    """(net, inp) of (N, H, W, 3) frames: tanh and relu of cnet's two
    halves."""
    c = encode(raft.cnet, frames)
    return torch.tanh(c[..., :HIDDEN_DIM]), F.relu(c[..., HIDDEN_DIM:])


def video_flows(raft, frames, iters=None, chunk=FIELD_CHUNK,
                spans=NO_SPANS):
    """Forward (i -> i+1) and backward (i+1 -> i) flows of every adjacent
    pair of (T, H, W, 3) frames in [-1, 1]: two (T-1, H, W, 2) float32
    tensors. Each frame's fnet and cnet run once; fields are refined
    `chunk` at a time, the forward and backward fields of chunk/2 pairs
    together. iters: default ITERS."""
    iters = ITERS if iters is None else iters
    t = frames.shape[0]
    frames = frames.float()
    fwd, bwd = [], []
    step = max(chunk // 2, 1)
    for s in range(0, t - 1, step):
        e = min(s + step, t - 1)
        clip = frames[s: e + 1]
        fmap = encode(raft.fnet, clip)
        net, inp = context(raft, clip)
        k = e - s
        # fields: s..e-1 -> s+1..e, then s+1..e -> s..e-1
        flows = refine(raft, torch.cat([fmap[:k], fmap[1:]]),
                       torch.cat([fmap[1:], fmap[:k]]),
                       torch.cat([net[:k], net[1:]]),
                       torch.cat([inp[:k], inp[1:]]), iters, spans)
        fwd.append(flows[:k])
        bwd.append(flows[k:])
    return torch.cat(fwd), torch.cat(bwd)
