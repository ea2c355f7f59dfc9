"""C2 (kernels/raft_conv.py, csrc/raft_conv.cu) on the CPU: its B operand
(the weight reordered, permuted, padded to the N-tile and split into tf32
parts) for every tap geometry against a numpy im2col in float64, the
kernel's schedule emulated in numpy (TMA's halo box of each geometry with
its zero fill and 128-byte swizzle, each thread's loads and A fragments,
the epilogues), the wrapper's plain path against F.conv2d and against the
concatenating form it replaces, what the wrapper refuses, RAFT's refine
and video_flows against their form before C2, and the reader of the
kernel's launch counter. The kernel itself runs in
tests/test_torch_propainter_cuda.py."""

import copy
import math
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels import raft_conv as rc
from e2fgvi_tpu_torch.kernels.deform import split_tf32
from e2fgvi_tpu_torch.models import raft

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "e2fgvi_tpu_torch" / "csrc" / "raft_conv.cu").read_text()
TW, TH = map(int, re.search(r"kTW = (\d+), kTH = (\d+);", SRC).groups())
BK = int(re.search(r"kBK = (\d+);", SRC).group(1))
GEOMETRIES = [(1, 1), (3, 3), (1, 5), (5, 1)]
# a K chunk's column 8kk + j holds channel 8 (j % 4) + 2kk + j // 4, as C1's
CHANNEL_OF_COLUMN = [8 * (j % 4) + 2 * kk + j // 4
                     for kk in range(4) for j in range(8)]
# RAFT's convolutions on C2: update_operands' name -> (Cin, Cout, kh, kw,
# epilogue)
COVERED = {"convc1": (324, 256, 1, 1, "relu"),
           "convc2": (256, 192, 3, 3, "relu"),
           "convf2": (128, 64, 3, 3, "relu"), "conv": (256, 126, 3, 3, "relu"),
           "fh1": (128, 256, 3, 3, "relu"), "fh2": (256, 2, 3, 3, "none"),
           "mask0": (128, 256, 3, 3, "relu"),
           "mask2": (256, 576, 1, 1, "none"),
           "zr1": (384, 256, 1, 5, "zr"), "q1": (384, 128, 1, 5, "gru"),
           "zr2": (384, 256, 5, 1, "zr"), "q2": (384, 128, 5, 1, "gru")}


def _weights(seed, cin, cout, kh, kw):
    g = torch.Generator().manual_seed(seed)
    wt = torch.randn((cout, cin, kh, kw), generator=g) * (
        cin * kh * kw) ** -0.5
    return wt, torch.randn((cout,), generator=g) * 0.1


def _map(seed, n, h, w, c, std=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, h, w, c), generator=g) * std


def _conv64(x, wt, b):
    """F.conv2d in float64, channel-last in and out, "same" padding."""
    kh, kw = wt.shape[2:]
    y = F.conv2d(x.double().permute(0, 3, 1, 2), wt.double(), b.double(),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", sorted(COVERED))
def test_n_tiles_of_raft_convolutions(name):
    """Each covered convolution's N-tile: the built width that pads Cout
    least (126 on one 128-wide tile, 2 on 8, 192 on two 96s, 576 on four
    144s), so conv_operands pads Cout to it."""
    cin, cout, kh, kw, _ = COVERED[name]
    want = {2: 8, 64: 64, 126: 128, 192: 96, 128: 128, 256: 128, 576: 144}
    assert rc.n_tile(kh, kw, cout) == want[cout]
    assert want[cout] in rc.BUILT[(kh, kw)]


@pytest.mark.parametrize("kh,kw,cin,cout", [
    (kh, kw, cin, cout) for kh, kw in GEOMETRIES
    for cin, cout in [(36, 126), (324, 2 if (kh, kw) == (3, 3) else 256),
                      (8, 576 if (kh, kw) == (1, 1) else 64)]])
def test_operands_against_numpy_im2col(kh, kw, cin, cout):
    """conv_operands' B operand (2, Cout_pad, kh kw Cin_pad) times a numpy
    im2col in the kernel's K order (chunk q = c kh kw + tap, C1's column
    permutation inside a chunk), in float64: the convolution within 2^-22
    of its scale; both parts tf32 (13 low bits zero), zero rows past Cout
    and zero columns past Cin."""
    wt, b = _weights(1, cin, cout, kh, kw)
    ops = rc.conv_operands(wt, b)
    chunks = -(-cin // BK)
    pad = -(-cout // ops.bn) * ops.bn
    assert ops.wk.shape == (2, pad, kh * kw * chunks * BK)
    assert not (ops.wk.view(torch.int32) & 0x1FFF).any()
    assert not ops.wk[:, cout:].any() and not ops.bk[cout:].any()
    assert torch.equal(ops.bk[:cout], b) and torch.equal(ops.weight, wt)
    n, h, w = 2, 5, 7
    x = _map(2, n, h, w, cin).double().numpy()
    xp = np.zeros((n, h + kh - 1, w + kw - 1, chunks * BK))
    xp[:, kh // 2: kh // 2 + h, kw // 2: kw // 2 + w, :cin] = x
    cols = []
    for c in range(chunks):
        for tap in range(kh * kw):
            ky, kx = divmod(tap, kw)
            chans = c * BK + np.asarray(CHANNEL_OF_COLUMN)
            cols.append(xp[:, ky: ky + h, kx: kx + w][..., chans])
    a = np.concatenate(cols, -1).reshape(n * h * w, -1)
    full = ops.wk[0].double().numpy() + ops.wk[1].double().numpy()
    got = a @ full.T + ops.bk.double().numpy()
    want = _conv64(torch.from_numpy(x), wt, b).reshape(n * h * w, cout)
    err = np.abs(got[:, :cout] - want.numpy()).max()
    assert err <= 2.0 ** -22 * np.abs(a).sum(1).max() * float(wt.abs().max())
    assert not got[:, cout:].any()
    big = split_tf32(rc.conv.conv_weight(F.pad(wt, (0, 0, 0, 0, 0, 0, 0,
                                                    pad - cout))))[0]
    assert torch.equal(ops.wk[0], big)


def _swizzled(rows):
    """Rows of 32 floats as TMA's 128-byte swizzle lays them in shared
    memory from a 1024-byte-aligned base: 16-byte chunk j of row r at
    chunk j ^ (r & 7)."""
    r = np.arange(rows.shape[0])[:, None]
    mem = np.empty((rows.shape[0], 8, 4), rows.dtype)
    mem[r, np.arange(8)[None] ^ (r & 7)] = rows.reshape(-1, 8, 4)
    return mem


# each consumer thread: warpgroup, warp, (g, t) of its quad, its tile row
_TID = np.arange(256)
_WG, _WARP, _LANE = _TID // 128, (_TID // 32) % 4, _TID % 32
_G, _T = _LANE // 4, _LANE % 4
_TY = 4 * _WG + _WARP
_ROW0 = 64 * _WG + 16 * _WARP + _G        # the thread's rows: _ROW0, + 8


def _a_tile(mem, hw, ky, kx):
    """The (128, 32) A operand the warpgroups' fragments make of a halo
    `hw` pixels wide for tap (ky, kx) (load_raw, then the k-step
    fragments)."""
    v = np.empty((256, 16), mem.dtype)
    for r in range(2):
        hr = (_TY + ky) * hw + _G + 8 * r + kx
        for hf in range(2):
            v[:, 8 * r + 4 * hf: 8 * r + 4 * hf + 4] = \
                mem[hr, (2 * _T + hf) ^ (hr & 7)]
    a = np.empty((128, BK), mem.dtype)
    for kk in range(4):
        a[_ROW0, 8 * kk + _T] = v[:, 2 * kk]
        a[_ROW0 + 8, 8 * kk + _T] = v[:, 8 + 2 * kk]
        a[_ROW0, 8 * kk + _T + 4] = v[:, 2 * kk + 1]
        a[_ROW0 + 8, 8 * kk + _T + 4] = v[:, 9 + 2 * kk]
    return a


def _parts(a):
    big, small = split_tf32(torch.from_numpy(np.ascontiguousarray(a)))
    return big.numpy(), small.numpy()


def _emulate(x, ops, act="none", net=None, z=None):
    """C2's schedule: a block per (16 x 8 tile, map, N-tile); chunk
    q = c kh kw + tap reads the halo box {32, 16 + kw - 1, 8 + kh - 1} of
    channel chunk c at (x0 - kw/2, y0 - kh/2), TMA's zero fill outside the
    map and past Cin; each chunk's three products in float64 rounded to
    float32, joining a float32 running sum; the epilogue on the pixels
    inside the map and the columns below Cout. Returns (out, z)."""
    xs = x.numpy()
    n_img, h, w, cin = xs.shape
    cout, _, kh, kw = ops.weight.shape
    taps, bn = kh * kw, ops.bn
    hw, hh = TW + kw - 1, TH + kh - 1
    chunks = -(-cin // BK)
    # x inside zeros: the halo of every tile lies inside
    xp = np.zeros((n_img, h + TH + kh, w + TW + kw, chunks * BK), np.float32)
    xp[:, kh // 2: kh // 2 + h, kw // 2: kw // 2 + w, :cin] = xs
    wk, bk = ops.wk.numpy(), ops.bk.numpy()
    width = cout // 2 if act == "zr" else cout
    out = np.full((n_img, h, w, width), np.nan, np.float32)
    zout = np.full((n_img, h, w, width), np.nan, np.float32)
    m = np.arange(TW * TH)
    for n in range(n_img):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                mems = [_swizzled(xp[n, y0:y0 + hh, x0:x0 + hw,
                                     BK * c: BK * c + BK].reshape(-1, BK))
                        for c in range(chunks)]
                for n0 in range(0, wk.shape[1], bn):
                    total = np.zeros((TW * TH, bn), np.float32)
                    for q in range(taps * chunks):
                        c, tap = divmod(q, taps)
                        ab, asm = _parts(_a_tile(mems[c], hw,
                                                 *divmod(tap, kw)))
                        bb = wk[0, n0:n0 + bn, BK * q: BK * q + BK]
                        bs = wk[1, n0:n0 + bn, BK * q: BK * q + BK]
                        acc = sum(a.astype(np.float64) @ b.T.astype(
                            np.float64) for a, b in ((asm, bb), (ab, bs),
                                                     (ab, bb)))
                        total += acc.astype(np.float32)
                    y, xx = y0 + m // TW, x0 + m % TW
                    keep = (y < h) & (xx < w)
                    cols = n0 + np.arange(bn)
                    live = cols < cout
                    v = total[keep][:, live] + bk[cols[live]]
                    cols = cols[live]
                    if act == "relu":
                        v = np.maximum(v, 0)
                    elif act == "zr":
                        v = 1 / (1 + np.exp(-v))
                        lo = cols < width
                        zout[n, y[keep][:, None], xx[keep][:, None],
                             cols[lo][None]] = v[:, lo]
                        hv = net.numpy()[n, y[keep], xx[keep]]
                        v = v[:, ~lo] * hv[:, cols[~lo] - width]
                        cols = cols[~lo] - width
                    elif act == "gru":
                        zz = z.numpy()[n, y[keep], xx[keep]][:, cols]
                        hv = net.numpy()[n, y[keep], xx[keep]][:, cols]
                        v = (1 - zz) * hv + zz * np.tanh(v)
                    out[n, y[keep][:, None], xx[keep][:, None],
                        cols[None]] = v
    return out, zout


def _epilogue_inputs(seed, n, h, w, width):
    net = _map(seed, n, h, w, width)
    z = torch.sigmoid(_map(seed + 1, n, h, w, width))
    return net, z


@pytest.mark.parametrize("kh,kw,cin,cout,act", [
    (1, 1, 36, 256, "relu"), (1, 1, 12, 576, "none"),
    (3, 3, 68, 126, "relu"), (3, 3, 36, 2, "none"), (3, 3, 64, 192, "relu"),
    (3, 3, 36, 64, "relu"), (3, 3, 40, 256, "zr"), (3, 3, 40, 128, "gru"),
    (1, 5, 40, 256, "zr"), (1, 5, 40, 128, "gru"), (1, 5, 36, 128, "relu"),
    (5, 1, 36, 256, "zr"), (5, 1, 36, 128, "gru"), (5, 1, 44, 128, "none")])
def test_kernel_schedule_matches_conv(kh, kw, cin, cout, act):
    """The emulated schedule against the float64 convolution and
    epilogue (raft_conv_plain in float64) on a 10 x 21 map (ragged tiles
    both ways): every output written once, each within 3xTF32's error."""
    n, h, w = 2, 10, 21
    x = _map(3, n, h, w, cin)
    wt, b = _weights(4, cin, cout, kh, kw)
    width = cout // 2 if act == "zr" else cout
    net, z = _epilogue_inputs(5, n, h, w, width)
    got, gz = _emulate(x, rc.conv_operands(wt, b), act, net, z)
    want = rc.raft_conv_plain(x.double(), wt.double(), b.double(), act,
                              net.double(), z.double())
    if act == "zr":
        wz, want = want
        assert np.abs(gz - wz.numpy()).max() <= 1e-6
    assert not np.isnan(got).any()
    assert np.abs(got - want.numpy()).max() <= 1e-5 * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("kh,kw", GEOMETRIES)
@pytest.mark.parametrize("act", ["none", "relu"])
def test_cpu_path_is_conv2d(kh, kw, act):
    """On the CPU the wrapper is conv_gemm then the epilogue: F.conv2d's
    result within float32 rounding, at every tap geometry, and it
    launches nothing."""
    x = _map(6, 2, 9, 13, 64)
    wt, b = _weights(7, 64, 128, kh, kw)
    before = rc.LAUNCHES["raft_conv"]
    got = rc.raft_conv(x, rc.conv_operands(wt, b), act)
    want = _conv64(x, wt, b)
    if act == "relu":
        want = want.clamp(min=0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.double() - want).abs().max() < 1e-5
    assert rc.LAUNCHES["raft_conv"] == before


def test_epilogues_sigmoid_tanh_zr_and_gru():
    """The GRU's epilogues: "zr" writes sigmoid of the z half into z and
    sigmoid of the r half times net into out; "gru" writes (1 - z) net +
    z tanh(q) over net; with z = 1 it is tanh alone, exactly."""
    n, h, w = 1, 6, 11
    x = _map(8, n, h, w, 384)
    wz, bz = _weights(9, 384, 128, 1, 5)
    wr, br = _weights(10, 384, 128, 1, 5)
    net = _map(11, n, h, w, 128)
    zr = rc.conv_operands(torch.cat([wz, wr]), torch.cat([bz, br]))
    z = torch.empty((n, h, w, 128))
    rnet = rc.raft_conv(x, zr, "zr", net=net, z=z)
    assert torch.allclose(z, torch.sigmoid(_conv64(x, wz, bz)).float(),
                          atol=1e-6)
    want = torch.sigmoid(_conv64(x, wr, br)) * net.double()
    assert (rnet.double() - want).abs().max() < 1e-6
    q = rc.conv_operands(wz, bz)
    state = net.clone()
    got = rc.raft_conv(x, q, "gru", out=state, net=state, z=z)
    assert got.data_ptr() == state.data_ptr()
    want = (1 - z.double()) * net.double() + z.double() * torch.tanh(
        _conv64(x, wz, bz))
    assert (state.double() - want).abs().max() < 1e-6
    ones = torch.ones_like(z)
    got = rc.raft_conv(x, q, "gru", net=net, z=ones)
    assert torch.equal(got, torch.tanh(rc.raft_conv(x, q)))


def test_channel_ranges_match_concatenation():
    """Inputs and outputs as channel ranges of one buffer (as update()
    keeps the GRU's state) give what the concatenated, contiguous tensors
    give, bit for bit, and leave the rest of the buffer untouched."""
    n, h, w = 2, 7, 9
    net, inp = _map(12, n, h, w, 128), _map(13, n, h, w, 128)
    m, flow = _map(14, n, h, w, 126), _map(15, n, h, w, 2)
    state = torch.full((n, h, w, raft.STATE), float("nan"))
    state[..., raft.NET], state[..., raft.INP] = net, inp
    state[..., raft.MOTION], state[..., raft.FLOW] = m, flow
    hx = torch.cat([net, inp, m, flow], -1)
    assert torch.equal(state[..., raft.HX], hx)
    wt, b = _weights(16, 384, 256, 5, 1)
    ops = rc.conv_operands(wt, b)
    z, z2 = torch.empty((n, h, w, 128)), torch.empty((n, h, w, 128))
    rc.raft_conv(state[..., raft.HX], ops, "zr", out=state[..., raft.RNET],
                 net=state[..., raft.NET], z=z)
    rnet = rc.raft_conv(hx, ops, "zr", net=net, z=z2)
    assert torch.equal(state[..., raft.RNET], rnet) and torch.equal(z, z2)
    assert torch.equal(state[..., raft.HX], hx)
    # q's input: [x, r * net] with the weight's input channels rotated
    wq, bq = _weights(17, 384, 128, 5, 1)
    rot = torch.cat([wq[:, 128:], wq[:, :128]], 1)
    got = rc.raft_conv(state[..., raft.XR], rc.conv_operands(rot, bq))
    want = rc.raft_conv(torch.cat([rnet, inp, m, flow], -1),
                        rc.conv_operands(wq, bq))
    assert (got - want).abs().max() <= 1e-5


def _refused(case):
    x = _map(18, 1, 5, 6, 128)
    wt, b = _weights(19, 128, 128, 3, 3)
    kw = {}
    if case == "dtype":
        x = x.bfloat16()
    elif case == "cin":
        x = x[..., :126]
    elif case == "pitch":
        x = _map(18, 1, 5, 6, 130)[..., :128]
    elif case == "out":
        kw["out"] = torch.empty((1, 5, 6, 64))
    elif case == "act":
        kw["act"] = "tanh"
    elif case == "zr_without_z":
        kw["act"] = "zr"
    elif case == "grad":
        x = x.requires_grad_()
    return x, rc.conv_operands(wt, b), kw


@pytest.mark.parametrize("case", ["dtype", "cin", "pitch", "out", "act",
                                  "zr_without_z"])
def test_wrapper_refuses(case):
    """What C2 does not take raises ValueError, on the CPU, on meta
    tensors (before any device check) and at the kernel's launcher."""
    x, ops, kw = _refused(case)
    with pytest.raises(ValueError):
        rc.raft_conv(x, ops, **kw)
    with pytest.raises(ValueError):
        rc.raft_conv(x.to("meta"), ops, **kw)
    with pytest.raises(ValueError):
        rc.raft_conv_kernel(x, ops, **kw)


def test_wrapper_refuses_grad():
    """Forward only: an input that requires grad under grad mode raises on
    every device; under no_grad the same call runs."""
    x, ops, _ = _refused("grad")
    with pytest.raises(RuntimeError, match="forward only"):
        rc.raft_conv(x, ops)
    with pytest.raises(RuntimeError, match="forward only"):
        rc.raft_conv(x.detach().to("meta").requires_grad_(), ops)
    with torch.no_grad():
        assert rc.raft_conv(x, ops).shape == (1, 5, 6, 128)


@pytest.mark.parametrize("shape", [(128, 128, 7, 7), (128, 128, 3, 5),
                                   (128, 2, 1, 1), (3, 128, 1, 1),
                                   (128, 6, 3, 3), (2, 128, 7, 7)])
def test_operands_refuse(shape):
    """Taps other than 1x1, 3x3, 1x5 and 5x1, an odd Cout, a Cin that is
    no multiple of 4 (convf1's 2), or a weight other than float32."""
    cout, cin, kh, kw = shape
    wt, b = _weights(20, cin, cout, kh, kw)
    if shape == (128, 2, 1, 1):
        wt = wt.double()
    with pytest.raises(ValueError):
        rc.conv_operands(wt, b)


def _update_concatenating(ub, net, inp, corr, flow):
    """update() before C2: each convolution on conv_gemm, the GRU's inputs
    assembled by torch.cat."""
    me = ub.encoder

    def conv(x, m):
        kh, kw = m.kernel_size
        return rc.conv_gemm(x, m.weight, m.bias, 1, (kh // 2, kw // 2))
    c = F.relu(conv(corr, me.convc1))
    c = F.relu(conv(c, me.convc2))
    f = F.relu(conv(flow, me.convf1))
    f = F.relu(conv(f, me.convf2))
    m = F.relu(conv(torch.cat([c, f], -1), me.conv))
    x = torch.cat([inp, m, flow], -1)
    g = ub.gru
    for z, r, q in ((g.convz1, g.convr1, g.convq1),
                    (g.convz2, g.convr2, g.convq2)):
        hx = torch.cat([net, x], -1)
        zt = torch.sigmoid(conv(hx, z))
        rt = torch.sigmoid(conv(hx, r))
        qt = torch.tanh(conv(torch.cat([rt * net, x], -1), q))
        net = (1 - zt) * net + zt * qt
    fh = ub.flow_head
    return net, conv(F.relu(conv(net, fh.conv1)), fh.conv2)


def _refine_concatenating(r, fmap1, fmap2, net, inp, iters):
    """refine() before C2."""
    levels = raft.corr_pyramid(fmap1, fmap2)
    n, h, w, _ = fmap1.shape
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    coords0 = torch.stack([xs, ys], -1).to(fmap1.dtype)[None].expand(
        n, h, w, 2)
    coords1 = coords0
    ub = r.update_block
    for _ in range(iters):
        corr = raft.corr_lookup(levels, coords1)
        net, delta = _update_concatenating(ub, net, inp, corr,
                                           coords1 - coords0)
        coords1 = coords1 + delta
    m = F.relu(rc.conv_gemm(net, ub.mask[0].weight, ub.mask[0].bias, 1,
                            (1, 1)))
    mask = 0.25 * rc.conv_gemm(m, ub.mask[2].weight, ub.mask[2].bias, 1,
                               (0, 0))
    return raft.upsample_flow(coords1 - coords0, mask)


@pytest.fixture(scope="module")
def seeded_raft():
    bench = str(ROOT / "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness.weights_propainter import make_state_dicts
    torch.set_num_threads(2)
    r = raft.RAFT()
    r.load_state_dict(make_state_dicts(9876543210123, torch.device("cpu"))[
        "raft"], strict=True)
    return r.eval()


def _frames(t, h, w, shift=(3, 2), seed=0):
    """Smooth frames in [-1, 1], each the last shifted by `shift` px."""
    g = torch.Generator().manual_seed(seed)
    big = F.interpolate(torch.rand((1, 3, (h + 4 * t) // 8, (w + 4 * t) // 8),
                                   generator=g),
                        size=(h + 4 * t, w + 4 * t), mode="bilinear")[0]
    dx, dy = shift
    return torch.stack([big[:, dy * i: dy * i + h, dx * i: dx * i + w]
                        for i in range(t)]).permute(0, 2, 3, 1) * 2 - 1


def _distances(got, want, want64):
    """max |got - want64| and max |want - want64|: each path's distance
    from the float64 form."""
    return (float((got.double() - want64).abs().max()),
            float((want.double() - want64).abs().max()))


@torch.no_grad()
def test_refine_matches_the_concatenating_form(seeded_raft):
    """refine on the state buffer (C2's plain path on the CPU) against
    refine before C2, on 4 fields at 128 x 192 (a 16 x 24 grid), 3
    iterations: the GEMMs' order changed (z and r stacked, q's inputs
    rotated), so the two differ by float32 rounding, which the iterations
    carry (the form before C2 lands 3.5e-6 of the flows' scale from
    float64): the new form no farther from float64 than the old."""
    r = seeded_raft
    f = _frames(3, 128, 192)
    fmap = raft.encode(r.fnet, f)
    net, inp = raft.context(r, f)
    args = (torch.cat([fmap[:2], fmap[1:]]), torch.cat([fmap[1:], fmap[:2]]),
            torch.cat([net[:2], net[1:]]), torch.cat([inp[:2], inp[1:]]))
    got = raft.refine(r, *args, iters=3)
    want = _refine_concatenating(r, *args, 3)
    want64 = _refine_concatenating(copy.deepcopy(r).double(),
                                   *(a.double() for a in args), 3)
    assert float(want.abs().max()) > 0.5
    new, old = _distances(got, want, want64)
    assert new <= 1.5 * old, (new, old)
    assert float((got - want).abs().max()) <= 2 * old


def _video_flows64(r, frames, iters, chunk):
    """video_flows' loop in float64 with refine before C2."""
    r, frames = copy.deepcopy(r).double(), frames.double()
    fwd, bwd = [], []
    step = chunk // 2
    for s in range(0, len(frames) - 1, step):
        e = min(s + step, len(frames) - 1)
        clip = frames[s: e + 1]
        fmap = raft.encode(r.fnet, clip)
        net, inp = raft.context(r, clip)
        k = e - s
        flows = _refine_concatenating(
            r, torch.cat([fmap[:k], fmap[1:]]), torch.cat([fmap[1:],
                                                           fmap[:k]]),
            torch.cat([net[:k], net[1:]]), torch.cat([inp[:k], inp[1:]]),
            iters)
        fwd.append(flows[:k])
        bwd.append(flows[k:])
    return torch.cat(fwd), torch.cat(bwd)


@torch.no_grad()
def test_video_flows_match_the_concatenating_form(seeded_raft, monkeypatch):
    """video_flows with refine on C2's path against the same with refine
    before C2 and that form in float64: 6 frames in chunks of 4 fields (3
    refines, the last ragged); the new form no farther from float64."""
    r = seeded_raft
    f = _frames(6, 64, 96, shift=(2, 1), seed=1)
    got = raft.video_flows(r, f, iters=2, chunk=4)
    monkeypatch.setattr(raft, "refine", lambda r, f1, f2, net, inp, iters,
                        spans: _refine_concatenating(r, f1, f2, net, inp,
                                                     iters))
    want = raft.video_flows(r, f, iters=2, chunk=4)
    want64 = _video_flows64(r, f, 2, 4)
    for a, b, b64 in zip(got, want, want64):
        assert a.shape == (5, 64, 96, 2) and float(b.abs().max()) > 0.1
        new, old = _distances(a, b, b64)
        assert new <= 1.5 * old, (new, old)


@torch.no_grad()
def test_refine_calls_c2_for_every_covered_convolution(seeded_raft,
                                                       monkeypatch):
    """Each iteration runs ten convolutions through raft_conv (all of
    update's but convf1) and the mask head two more, each with the
    operands update_operands made once: 10 iters + 2 calls a refine, so a
    video of T frames makes 202 ceil((T - 1) / 8) launches at ITERS 20
    and FIELD_CHUNK 16 (PERF.md's prediction for the pool)."""
    calls = []
    orig = rc.raft_conv

    def record(x, ops, act="none", **k):
        calls.append((tuple(ops.weight.shape), act))
        return orig(x, ops, act, **k)

    monkeypatch.setattr(rc, "raft_conv", record)
    made = []
    orig_ops = raft.update_operands
    monkeypatch.setattr(raft, "update_operands",
                        lambda ub: made.append(1) or orig_ops(ub))
    r = seeded_raft
    f = _frames(4, 64, 96)
    raft.video_flows(r, f, iters=3, chunk=4)
    refines = math.ceil((4 - 1) / 2)
    assert len(made) == refines
    assert len(calls) == refines * (10 * 3 + 2)
    per_iter = calls[:10]
    assert [(s[0], s[1], s[2], s[3], a) for s, a in per_iter] == [
        (256, 324, 1, 1, "relu"), (192, 256, 3, 3, "relu"),
        (64, 128, 3, 3, "relu"), (126, 256, 3, 3, "relu"),
        (256, 384, 1, 5, "zr"), (128, 384, 1, 5, "gru"),
        (256, 384, 5, 1, "zr"), (128, 384, 5, 1, "gru"),
        (256, 128, 3, 3, "relu"), (2, 256, 3, 3, "none")]
    assert calls[30:32] == [((256, 128, 3, 3), "relu"),
                            ((576, 256, 1, 1), "none")]
    covered = {(cout, cin, kh, kw) for cin, cout, kh, kw, _ in
               COVERED.values()}
    assert {s for s, _ in calls} == covered
    pool = [25, 60, 80, 104]
    assert sum(202 * math.ceil((t - 1) / (raft.FIELD_CHUNK // 2))
               for t in pool) / len(pool) == 1717.0


def _reader():
    bench = str(ROOT / "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness import common
    return common.reader("raft_conv_launches_per_video.propainter")


def test_launch_reader():
    """perfbench/metrics/raft_conv_launches_per_video.py: the program's
    raft_conv_launches per traced video; None where the program has no
    such counter (a parent without C2) or no video completed; 0 read as 0."""
    read = _reader().read
    run = {"kind": "serve", "frames": 269, "latencies": [1.0] * 4,
           "stages_ms": {"flows": 100.0, "raft_conv_launches": 6868,
                         "raft_conv_launches.raft_update": 6868}}
    assert read(run) == 1717.0
    assert read(dict(run, stages_ms={"flows": 100.0,
                                     "raft_conv_launches": 0})) == 0
    assert read(dict(run, stages_ms={"flows": 100.0})) is None
    assert read(dict(run, stages_ms=None)) is None
    assert read(dict(run, latencies=[])) is None
    assert os.path.basename(_reader().__file__) == \
        "raft_conv_launches_per_video.py"
