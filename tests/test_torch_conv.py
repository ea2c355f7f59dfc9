"""C (kernels/conv.py, csrc/conv.cu) on the CPU: its B operand (the weight
reordered, permuted, padded to the N-tile and split into tf32 parts) for
every tap geometry against a numpy im2col in float64, the kernel's schedule
emulated in numpy for every tap geometry and epilogue (TMA's halo box with
its zero fill and 128-byte swizzle, each thread's loads and A fragments,
the wgmma's k-columns, the epilogue), its 3xTF32 precision, the entry
points' CPU path against ops.convs.conv2d, channel ranges against
concatenation, the encoder's grouped layers as one call a group on channel
ranges, what the entry points refuse, and feat_prop's and the encoder's
dispatch. The kernel itself runs in tests/test_torch_cuda.py (conv3x3,
encoder_conv) and tests/test_torch_propainter_cuda.py (raft_conv)."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e2fgvi_tpu_torch.data import pipeline
from e2fgvi_tpu_torch.kernels import conv
from e2fgvi_tpu_torch.kernels.deform import split_tf32
from e2fgvi_tpu_torch.models import e2fgvi, feat_prop, raft
from e2fgvi_tpu_torch.ops.convs import conv2d, leaky_relu

SRC = (Path(conv.__file__).resolve().parents[1] / "csrc" / "conv.cu"
       ).read_text()
TW, TH = map(int, re.search(r"kTW = (\d+), kTH = (\d+);", SRC).groups())
BK = int(re.search(r"kBK = (\d+);", SRC).group(1))
GEOMETRIES = [(1, 1), (3, 3), (1, 5), (5, 1)]
# a K chunk's column 8kk + j holds channel 8 (j % 4) + 2kk + j // 4 (the
# wgmma's k-step kk, k-column j: thread t of a quad hands k-step kk its
# channels 8t + 2kk and 8t + 2kk + 1)
CHANNEL_OF_COLUMN = [8 * (j % 4) + 2 * kk + j // 4
                     for kk in range(4) for j in range(8)]
# the port's convolutions on C: name -> (Cin, Cout, kh, kw, epilogue).
# RAFT's (models/raft.py update_operands' names) and feat_prop's six
# (the offset head's four, the backbone's two: 256 backward, 384 forward,
# then 128 with the residual)
CONVS = {"convc1": (324, 256, 1, 1, "relu"),
         "convc2": (256, 192, 3, 3, "relu"),
         "convf2": (128, 64, 3, 3, "relu"), "conv": (256, 126, 3, 3, "relu"),
         "fh1": (128, 256, 3, 3, "relu"), "fh2": (256, 2, 3, 3, "none"),
         "mask0": (128, 256, 3, 3, "relu"),
         "mask2": (256, 576, 1, 1, "none"),
         "zr1": (384, 256, 1, 5, "zr"), "q1": (384, 128, 1, 5, "gru"),
         "zr2": (384, 256, 5, 1, "zr"), "q2": (384, 128, 5, 1, "gru"),
         "offset0": (388, 128, 3, 3, "leaky"),
         "offset1": (128, 128, 3, 3, "leaky"),
         "offset3": (128, 432, 3, 3, "none"),
         "backbone0": (256, 128, 3, 3, "leaky"),
         "backbone0_fwd": (384, 128, 3, 3, "leaky"),
         "backbone1": (128, 128, 3, 3, "residual"),
         # the E2FGVI encoder's seven stride-1 layers (models/e2fgvi.py
         # _ENC_PLAN's index), a grouped one by its groups' shape
         "enc1": (64, 64, 3, 3, "leaky"), "enc3": (128, 256, 3, 3, "leaky"),
         "enc4": (256, 384, 3, 3, "leaky"),
         "enc5_g2": (320, 256, 3, 3, "leaky"),
         "enc6_g4": (192, 96, 3, 3, "leaky"),
         "enc7_g8": (80, 32, 3, 3, "leaky"),
         "enc8": (512, 128, 3, 3, "leaky")}
SLOPE = 0.1


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


@pytest.mark.parametrize("name", sorted(CONVS))
def test_n_tiles_of_the_ports_convolutions(name):
    """Each convolution's N-tile: the built width that pads Cout least, the
    widest among equals (126 on one 128-wide tile, 2 on 8, 192 on two 96s,
    432 on three 144s and 576 on four; the encoder's groups of 32 on 32,
    of 96 on 96, its 384 on three 128s), so conv_operands pads Cout to
    it."""
    cin, cout, kh, kw, _ = CONVS[name]
    want = {2: 8, 32: 32, 64: 64, 96: 96, 126: 128, 192: 96, 128: 128,
            256: 128, 384: 128, 432: 144, 576: 144}
    assert conv.n_tile(kh, kw, cout) == want[cout]
    assert want[cout] in conv.BUILT[(kh, kw)]


@pytest.mark.parametrize("kh,kw,cin,cout", [
    (kh, kw, cin, cout) for kh, kw in GEOMETRIES
    for cin, cout in [(36, 126), (324, 2 if (kh, kw) == (3, 3) else 256),
                      (8, 576 if (kh, kw) == (1, 1) else 64)]] + [
    (3, 3, cin, cout) for cin, cout in [(388, 128), (128, 128), (128, 432),
                                        (256, 128), (384, 128), (36, 128),
                                        (4, 432)]])
def test_operands_against_numpy_im2col(kh, kw, cin, cout):
    """conv_operands' B operand (2, Cout_pad, kh kw Cin_pad): chunk q =
    c kh kw + tap, column j is channel 32c + CHANNEL_OF_COLUMN[j] of that
    tap (big + small rebuilds the weight within 2^-22 of its scale); times
    a numpy im2col in that K order, in float64, it is the convolution
    within 2^-22 of its scale; both parts tf32 (13 low bits zero), zero
    rows past Cout and zero columns past Cin."""
    wt, b = _weights(1, cin, cout, kh, kw)
    ops = conv.conv_operands(wt, b)
    chunks = -(-cin // BK)
    pad = -(-cout // ops.bn) * ops.bn
    taps = kh * kw
    assert ops.wk.shape == (2, pad, taps * chunks * BK)
    assert ops.wk.dtype == torch.float32
    assert not (ops.wk.view(torch.int32) & 0x1FFF).any()
    assert not ops.wk[:, cout:].any() and not ops.bk[cout:].any()
    assert torch.equal(ops.bk[:cout], b) and torch.equal(ops.weight, wt)
    perm = np.asarray(CHANNEL_OF_COLUMN)
    assert sorted(perm) == list(range(BK))
    rebuilt = torch.zeros((cout, chunks * BK, kh, kw), dtype=torch.float64)
    full = (ops.wk[0, :cout].double() + ops.wk[1, :cout].double()).reshape(
        cout, chunks, taps, BK)
    for c in range(chunks):
        for tap in range(taps):
            rebuilt[:, c * BK + perm, tap // kw, tap % kw] = full[:, c, tap]
    assert not rebuilt[:, cin:].any()
    err = (rebuilt[:, :cin] - wt.double()).abs().max()
    assert err <= 2.0 ** -22 * wt.abs().max()
    n, h, w = 2, 5, 7
    x = _map(2, n, h, w, cin).double().numpy()
    xp = np.zeros((n, h + kh - 1, w + kw - 1, chunks * BK))
    xp[:, kh // 2: kh // 2 + h, kw // 2: kw // 2 + w, :cin] = x
    cols = []
    for c in range(chunks):
        for tap in range(taps):
            ky, kx = divmod(tap, kw)
            cols.append(xp[:, ky: ky + h, kx: kx + w][..., c * BK + perm])
    a = np.concatenate(cols, -1).reshape(n * h * w, -1)
    full = ops.wk[0].double().numpy() + ops.wk[1].double().numpy()
    got = a @ full.T + ops.bk.double().numpy()
    want = _conv64(torch.from_numpy(x), wt, b).reshape(n * h * w, cout)
    err = np.abs(got[:, :cout] - want.numpy()).max()
    assert err <= 2.0 ** -22 * np.abs(a).sum(1).max() * float(wt.abs().max())
    assert not got[:, cout:].any()
    big = split_tf32(conv.conv_weight(F.pad(wt, (0, 0, 0, 0, 0, 0, 0,
                                                 pad - cout))))[0]
    assert torch.equal(ops.wk[0], big)


def _swizzled(rows):
    """Rows of 32 floats as TMA's 128-byte swizzle lays them in shared
    memory from a 1024-byte-aligned base: 16-byte chunk j of row r at
    chunk j ^ (r & 7). (rows, 8, 4)."""
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
    `hw` pixels wide for tap (ky, kx): each thread's two 16-byte loads of
    each of its rows (load_raw), then k-step kk's fragment (g, t) = channel
    8t + 2kk of row g, (g + 8, t) of row g + 8, (g, t + 4) = channel
    8t + 2kk + 1, ..."""
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


def _emulate(x, ops, act="none", net=None, z=None, residual=None,
             products=("sb", "bs", "bb")):
    """C's schedule: a block per (16 x 8 tile, map, N-tile); chunk
    q = c kh kw + tap reads the halo box {32, 16 + kw - 1, 8 + kh - 1} of
    channel chunk c at (x0 - kw/2, y0 - kh/2), TMA's zero fill outside the
    map and past Cin; each chunk's products in float64 rounded to float32
    (the tensor cores' float32 accumulator), joining a float32 running sum;
    the epilogue (bias, act, residual) on the pixels inside the map and
    the columns below Cout. Returns (out, z)."""
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
                        terms = {"sb": (asm, bb), "bs": (ab, bs),
                                 "bb": (ab, bb)}
                        acc = sum(a.astype(np.float64) @ b.T.astype(
                            np.float64) for a, b in (terms[p]
                                                     for p in products))
                        total += acc.astype(np.float32)
                    y, xx = y0 + m // TW, x0 + m % TW
                    keep = (y < h) & (xx < w)
                    cols = n0 + np.arange(bn)
                    live = cols < cout
                    v = total[keep][:, live] + bk[cols[live]]
                    cols = cols[live]
                    if act == "relu":
                        v = np.maximum(v, 0)
                    elif act == "leaky":
                        v = np.where(v > 0, v, v * np.float32(SLOPE))
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
                    if residual is not None:
                        v = residual.numpy()[n, y[keep], xx[keep]][:, cols] \
                            + v
                    out[n, y[keep][:, None], xx[keep][:, None],
                        cols[None]] = v
    return out, zout


def _epilogue_inputs(seed, n, h, w, width, epilogue):
    """net, z and the residual an epilogue reads (None where it reads
    none), and the act it runs ("residual": none, then the add)."""
    net = _map(seed, n, h, w, width)
    z = torch.sigmoid(_map(seed + 1, n, h, w, width))
    res = _map(seed + 2, n, h, w, width)
    act = "none" if epilogue == "residual" else epilogue
    return (act, net if act in ("zr", "gru") else None,
            z if act in ("zr", "gru") else None,
            res if epilogue == "residual" else None)


@pytest.mark.parametrize("n,h,w,kh,kw,cin,cout,epilogue", [
    (2, 10, 21, kh, kw, cin, cout, act) for kh, kw, cin, cout, act in [
        (1, 1, 36, 256, "relu"), (1, 1, 12, 576, "none"),
        (3, 3, 68, 126, "relu"), (3, 3, 36, 2, "none"),
        (3, 3, 64, 192, "relu"), (3, 3, 36, 64, "relu"),
        (3, 3, 40, 256, "zr"), (3, 3, 40, 128, "gru"), (1, 5, 40, 256, "zr"),
        (1, 5, 40, 128, "gru"), (1, 5, 36, 128, "relu"),
        (5, 1, 36, 256, "zr"), (5, 1, 36, 128, "gru"),
        (5, 1, 44, 128, "none")]] + [
    (n, h, w, 3, 3, cin, cout, epilogue)
    for n, h, w, cin, cout in [
        (2, 10, 20, 36, 128),    # ragged tiles both ways, a 4-channel chunk
        (1, 8, 16, 64, 432),     # whole tiles; three 144-wide N-tiles
        (1, 9, 17, 388, 128)]    # the offset head's first layer
    for epilogue in ("none", "leaky", "residual")] + [
    # the encoder's groups: Cin_g 80 (a 16-channel last chunk) on BN 32,
    # 192 on BN 96, 320 on two 128-wide N-tiles
    (1, 9, 17, 3, 3, cin, cout, "leaky")
    for cin, cout in [(80, 32), (192, 96), (320, 256)]])
def test_kernel_schedule_matches_conv(n, h, w, kh, kw, cin, cout, epilogue):
    """The emulated schedule against the float64 convolution and epilogue
    (conv_plain in float64) on maps with ragged tiles: every output
    written once, each within 3xTF32's error."""
    x = _map(3, n, h, w, cin)
    wt, b = _weights(4, cin, cout, kh, kw)
    act, net, z, res = _epilogue_inputs(
        5, n, h, w, cout // 2 if epilogue == "zr" else cout, epilogue)
    slope = SLOPE if act == "leaky" else None
    got, gz = _emulate(x, conv.conv_operands(wt, b), act, net, z, res)
    want = conv.conv_plain(*(None if t is None else t.double()
                             for t in (x, wt, b, res)), act, slope,
                           *(None if t is None else t.double()
                             for t in (net, z)))
    if act == "zr":
        wz, want = want
        assert np.abs(gz - wz.numpy()).max() <= 1e-6
    assert not np.isnan(got).any()
    assert np.abs(got - want.numpy()).max() <= 1e-5 * max(
        1.0, float(want.abs().max()))


def test_3xtf32_keeps_float32_accuracy():
    """The precision argument: the three products, each chunk's summed
    from zero and joined by a float32 add, land as close to float64 as a
    float32 convolution does; one TF32 pass (big * big) does not."""
    x = _map(2, 1, 8, 16, 388)
    wt, b = _weights(2, 388, 128, 3, 3)
    ops = conv.conv_operands(wt, b)
    want = conv.conv_plain(x.double(), wt.double(), b.double()).numpy()
    f32 = np.abs(conv.conv_plain(x, wt, b).numpy() - want).max()
    three = np.abs(_emulate(x, ops)[0] - want).max()
    one = np.abs(_emulate(x, ops, products=("bb",))[0] - want).max()
    assert three <= 2 * f32, (three, f32)
    assert one >= 20 * f32, (one, f32)


@pytest.mark.parametrize("entry,kh,kw,epilogue", [
    ("raft_conv", kh, kw, act) for kh, kw in GEOMETRIES
    for act in ("none", "relu")] + [
    ("conv3x3", 3, 3, epilogue) for epilogue in ("none", "leaky",
                                                 "residual")])
def test_cpu_path_is_conv2d_and_epilogue(entry, kh, kw, epilogue):
    """On the CPU each entry point is ops.convs.conv2d, then the epilogue:
    F.conv2d's float64 result within float32 rounding, at every tap
    geometry, and conv3x3 that call exactly; it launches nothing."""
    cin, cout = (64, 128) if entry == "raft_conv" else (388, 128)
    if entry == "conv3x3" and epilogue == "none":
        cout = 432
    x = _map(6, 2, 9, 13, cin)
    wt, b = _weights(7, cin, cout, kh, kw)
    res = _map(8, 2, 9, 13, cout)
    before = dict(conv.LAUNCHES)
    want = conv2d(x, wt, b, padding=(kh // 2, kw // 2))
    want64 = _conv64(x, wt, b)
    if entry == "raft_conv":
        got = conv.raft_conv(x, conv.conv_operands(wt, b), epilogue)
        if epilogue == "relu":
            want, want64 = F.relu(want), want64.clamp(min=0)
    elif epilogue == "leaky":
        got = conv.conv3x3(x, wt, b, negative_slope=SLOPE)
        want, want64 = leaky_relu(want, SLOPE), leaky_relu(want64, SLOPE)
    elif epilogue == "residual":
        got = conv.conv3x3(x, wt, b, residual=res)
        want, want64 = res + want, res.double() + want64
    else:
        got = conv.conv3x3(x, wt, b)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.is_contiguous()
    if entry == "conv3x3":
        assert torch.equal(got, want)
    assert (got.double() - want64).abs().max() < 1e-5
    assert conv.LAUNCHES == before


def test_epilogues_sigmoid_tanh_zr_and_gru():
    """The GRU's epilogues: "zr" writes sigmoid of the z half into z and
    sigmoid of the r half times net into out; "gru" writes (1 - z) net +
    z tanh(q) over net; with z = 1 it is tanh alone, exactly."""
    n, h, w = 1, 6, 11
    x = _map(8, n, h, w, 384)
    wz, bz = _weights(9, 384, 128, 1, 5)
    wr, br = _weights(10, 384, 128, 1, 5)
    net = _map(11, n, h, w, 128)
    zr = conv.conv_operands(torch.cat([wz, wr]), torch.cat([bz, br]))
    z = torch.empty((n, h, w, 128))
    rnet = conv.raft_conv(x, zr, "zr", net=net, z=z)
    assert torch.allclose(z, torch.sigmoid(_conv64(x, wz, bz)).float(),
                          atol=1e-6)
    want = torch.sigmoid(_conv64(x, wr, br)) * net.double()
    assert (rnet.double() - want).abs().max() < 1e-6
    q = conv.conv_operands(wz, bz)
    state = net.clone()
    got = conv.raft_conv(x, q, "gru", out=state, net=state, z=z)
    assert got.data_ptr() == state.data_ptr()
    want = (1 - z.double()) * net.double() + z.double() * torch.tanh(
        _conv64(x, wz, bz))
    assert (state.double() - want).abs().max() < 1e-6
    ones = torch.ones_like(z)
    got = conv.raft_conv(x, q, "gru", net=net, z=ones)
    assert torch.equal(got, torch.tanh(conv.raft_conv(x, q)))


def test_channel_ranges_match_concatenation():
    """Inputs and outputs as channel ranges of one buffer (as raft.update
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
    ops = conv.conv_operands(wt, b)
    z, z2 = torch.empty((n, h, w, 128)), torch.empty((n, h, w, 128))
    conv.raft_conv(state[..., raft.HX], ops, "zr", out=state[..., raft.RNET],
                   net=state[..., raft.NET], z=z)
    rnet = conv.raft_conv(hx, ops, "zr", net=net, z=z2)
    assert torch.equal(state[..., raft.RNET], rnet) and torch.equal(z, z2)
    assert torch.equal(state[..., raft.HX], hx)
    # q's input: [x, r * net] with the weight's input channels rotated
    wq, bq = _weights(17, 384, 128, 5, 1)
    rot = torch.cat([wq[:, 128:], wq[:, :128]], 1)
    got = conv.raft_conv(state[..., raft.XR], conv.conv_operands(rot, bq))
    want = conv.raft_conv(torch.cat([rnet, inp, m, flow], -1),
                          conv.conv_operands(wq, bq))
    assert (got - want).abs().max() <= 1e-5


# the encoder's grouped layers: (Cin, Cout, groups)
ENC_GROUPED = [(640, 512, 2), (768, 384, 4), (640, 256, 8)]


@pytest.mark.parametrize("cin,cout,groups", ENC_GROUPED)
def test_grouped_channel_ranges_match_per_group_copies(monkeypatch, cin,
                                                       cout, groups):
    """encoder_conv runs a grouped layer as one call a group on a channel
    range of one input and of one output buffer (views at their buffers'
    pixel pitch, nothing copied): bit for bit what each group's contiguous
    copy gives, concatenated."""
    n, h, w = 2, 7, 9
    x = _map(23, n, h, w, cin)
    wt, b = _weights(24, cin // groups, cout, 3, 3)
    ops = conv.group_operands(wt, b, groups)
    seen = []
    plain = conv.plain_call

    def record(xg, o, act, out, **k):
        seen.append((xg.stride(2), out.stride(2), xg.is_contiguous()))
        return plain(xg, o, act, out, **k)
    monkeypatch.setattr(conv, "plain_call", record)
    got = conv.encoder_conv(x, ops, 0.2)
    cg = cin // groups
    want = torch.cat([plain(x[..., g * cg:(g + 1) * cg].contiguous(),
                            ops[g], "leaky", negative_slope=0.2)
                      for g in range(groups)], -1)
    assert seen == [(cin, cout, False)] * groups
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("cin,cout,groups", ENC_GROUPED + [(128, 256, 1)])
def test_group_decomposition_is_grouped_conv2d(cin, cout, groups):
    """The group-by-views decomposition on the plain form is
    F.conv2d(groups=groups) with LeakyReLU(0.2): in float32 within
    float32 rounding, and within it of float64; group_operands holds
    each group's rows of the weight and the bias."""
    x = _map(25, 2, 8, 11, cin)
    wt, b = _weights(26, cin // groups, cout, 3, 3)
    ops = conv.group_operands(wt, b, groups)
    cg = cout // groups
    assert [o.bn for o in ops] == [conv.n_tile(3, 3, cg)] * groups
    for g, o in enumerate(ops):
        assert torch.equal(o.weight, wt[g * cg:(g + 1) * cg])
        assert torch.equal(o.bias, b[g * cg:(g + 1) * cg])
    before = dict(conv.LAUNCHES)
    got = conv.encoder_conv(x, ops, 0.2)
    assert conv.LAUNCHES == before

    def grouped(dtype):
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), wt.to(dtype),
                     b.to(dtype), padding=1, groups=groups)
        return F.leaky_relu(y, 0.2).permute(0, 2, 3, 1)
    assert got.shape == (2, 8, 11, cout)
    assert (got - grouped(torch.float32)).abs().max() <= 1e-5
    assert (got.double() - grouped(torch.float64)).abs().max() <= 1e-5


def _refused(entry, case):
    """(call(x, tensor map), the launcher's call, x) of a case the entry
    point refuses."""
    x = _map(18, 1, 5, 6, 128)
    wt, b = _weights(19, 128, 128, 3, 3)
    kw = {}
    if entry == "raft_conv":
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
        ops = conv.conv_operands(wt, b)
        return (lambda x, to: conv.raft_conv(to(x), ops, **kw),
                lambda: conv.launch(x, ops, **kw), x)
    if case == "bf16":
        x, wt, b = x.bfloat16(), wt.bfloat16(), b.bfloat16()
    elif case == "stride":
        kw["stride"] = 2
    elif case == "kernel":
        wt = wt[..., :1, :1].contiguous()
    elif case == "cin":
        x, wt = x[..., :126].contiguous(), wt[:, :126].contiguous()
    elif case == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "cout":                 # the epilogue stores column pairs
        wt, b = wt[:127], b[:127]
    elif case == "residual_ragged":      # 126 on a 128-wide N-tile
        wt, b = wt[:126], b[:126]
        kw["residual"] = _map(18, 1, 5, 6, 126)
    launch = (lambda: conv.launch(x, conv.conv_operands(wt, b),
                                  residual=kw.get("residual")))
    return (lambda x, to: conv.conv3x3(
        to(x), to(wt), to(b),
        **{k: to(v) if torch.is_tensor(v) else v for k, v in kw.items()}),
        None if "stride" in kw else launch, x)


@pytest.mark.parametrize("entry,case", [
    ("raft_conv", case) for case in ("dtype", "cin", "pitch", "out", "act",
                                     "zr_without_z")] + [
    ("conv3x3", case) for case in ("bf16", "stride", "kernel", "cin",
                                   "non_contiguous", "cout",
                                   "residual_ragged")])
def test_wrapper_refuses(entry, case):
    """What C does not take raises ValueError, on every device: here on
    the CPU and on meta tensors (the device's checks come after), and at
    the kernel's launcher itself."""
    call, launch, x = _refused(entry, case)
    with pytest.raises(ValueError):
        call(x, lambda t: t)
    with pytest.raises(ValueError):
        call(x, lambda t: t.to("meta"))
    if launch is not None:
        with pytest.raises(ValueError):
            launch()


def test_wrapper_refuses_grad():
    """raft_conv is forward only: an input that requires grad under grad
    mode raises on every device; under no_grad the same call runs."""
    x = _map(18, 1, 5, 6, 128).requires_grad_()
    ops = conv.conv_operands(*_weights(19, 128, 128, 3, 3))
    with pytest.raises(RuntimeError, match="forward only"):
        conv.raft_conv(x, ops)
    with pytest.raises(RuntimeError, match="forward only"):
        conv.raft_conv(x.detach().to("meta").requires_grad_(), ops)
    with torch.no_grad():
        assert conv.raft_conv(x, ops).shape == (1, 5, 6, 128)


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
        conv.conv_operands(wt, b)


class _Cuda(torch.Tensor):
    """A CPU tensor that says it is on CUDA: feat_prop's dispatch reads the
    flag."""
    is_cuda = True


def test_feat_prop_routes_float32_cuda_convolutions_to_c1(monkeypatch):
    """feat_prop's dispatch by what it sees: a float32 CUDA tensor goes to
    C (conv3x3, with its operands), others to the plain form. CUDA is stood
    in by a flag on the tensor."""
    calls = []
    monkeypatch.setattr(conv, "conv3x3", lambda x, *a, **k: calls.append(
        ("c", x.dtype)) or conv.conv_plain(x, *a[:2]))
    plain = conv.conv_plain

    def record(x, *a, **k):
        calls.append(("plain", x.dtype))
        return plain(x, *a, **k)
    monkeypatch.setattr(conv, "conv_plain", record)
    layer = torch.nn.Conv2d(8, 128, 3, padding=1)
    x = torch.randn(1, 4, 5, 8)
    feat_prop.conv3x3(x, layer)
    feat_prop.conv3x3(x.bfloat16(), layer.bfloat16())
    assert [c[0] for c in calls] == ["plain", "plain"]
    calls.clear()
    feat_prop.conv3x3(x.as_subclass(_Cuda), layer.float())
    assert calls[0] == ("c", torch.float32)
    assert feat_prop.conv3x3_operands([layer], x) == [None]


def test_encoder_routes_float32_cuda_stride1_layers_to_c(monkeypatch):
    """The encoder's dispatch by what it sees: a float32 CUDA input outside
    autograd sends layers 1 and 3-8 to C, 18 launches (one a group: 1 + 1
    + 1 + 2 + 4 + 8 + 1), each with the bias and LeakyReLU(0.2), and the
    two stride-2 layers to conv2d, the result the plain chain's within
    float32 rounding; bfloat16, the CPU and grad mode run every layer on
    conv2d. CUDA is stood in by a flag on the tensor."""
    launches, convs = [], []

    def fake_launch(x, ops, act, out, negative_slope, counter):
        launches.append((x.shape[3], x.stride(2), tuple(ops.weight.shape),
                         act, negative_slope, counter))
        return out.copy_(conv.conv_plain(x, ops.weight, ops.bias, act=act,
                                         negative_slope=negative_slope))

    def record(x, w, b=None, stride=1, padding=0, groups=1):
        convs.append((x.shape[3], stride, groups))
        return conv2d(x, w, b, stride, padding, groups)
    monkeypatch.setattr(conv, "launch", fake_launch)
    monkeypatch.setattr(e2fgvi, "conv2d", record)
    torch.manual_seed(0)
    enc = e2fgvi.Encoder()
    for m in enc.layers[::2]:
        torch.nn.init.normal_(m.bias, std=0.1)
    x = _map(27, 2, 16, 24, 3)
    every = [(cin, stride, groups)
             for cin, _, stride, groups in e2fgvi._ENC_PLAN]
    with torch.no_grad():
        want = enc(x)
        assert convs == every and not launches
        convs.clear()
        got = enc(x.as_subclass(_Cuda))
        assert convs == [(3, 2, 1), (64, 2, 1)]
        assert [(c, w[0], g) for c, _, w, *_, g in launches] == [
            (64, 64, "encoder"), (128, 256, "encoder"),
            (256, 384, "encoder")] + [(320, 256, "encoder")] * 2 + [
            (192, 96, "encoder")] * 4 + [(80, 32, "encoder")] * 8 + [
            (512, 128, "encoder")]
        assert {(a, s) for *_, a, s, _ in launches} == {("leaky", 0.2)}
        assert [p for _, p, *_ in launches[3:]] == [640] * 2 + [768] * 4 + \
            [640] * 8 + [512]
        assert got.shape == want.shape == (2, 4, 6, 128)
        assert (got - want).abs().max() <= 1e-5
        convs.clear()
        launches.clear()
        enc(x.bfloat16().as_subclass(_Cuda))
    assert convs == every and not launches
    convs.clear()
    out = enc(x.as_subclass(_Cuda))
    assert convs == every and not launches and out.requires_grad
    assert enc.kernel_operands(x) == {}


def test_encoder_launch_reader():
    """perfbench/metrics/encoder_conv_launches_per_video.py: the program's
    encoder_conv_launches per traced video, 40.5 on the f32 cell's pool
    (lengths 25, 60, 80, 104: 9 encoder calls of up to ENC_CHUNK frames,
    18 launches each); None where the program has no such counter (a
    parent without it) or no video completed; 0 (bfloat16) read as 0."""
    bench = str(Path(__file__).resolve().parents[1] / "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness import common
    module = common.reader("encoder_conv_launches_per_video.f32")
    assert Path(module.__file__).name == "encoder_conv_launches_per_video.py"
    pool = [25, 60, 80, 104]
    n = sum(18 * -(-t // pipeline.ENC_CHUNK) for t in pool)
    run = {"kind": "serve", "frames": sum(pool), "latencies": [1.0] * 4,
           "stages_ms": {"encode": 100.0, "encoder_conv_launches": n,
                         "encoder_conv_launches.encode": n}}
    assert module.read(run) == 40.5
    assert module.read(dict(run, stages_ms={
        "encode": 100.0, "encoder_conv_launches": 0})) == 0
    assert module.read(dict(run, stages_ms={"encode": 100.0})) is None
    assert module.read(dict(run, stages_ms=None)) is None
    assert module.read(dict(run, latencies=[])) is None


@pytest.mark.parametrize("cin", [261, 258])
def test_feat_prop_pads_cin_to_a_multiple_of_4(monkeypatch, cin):
    """For C, feat_prop gives x and the weight zero channels up to a
    multiple of 4 (ProPainter's Cin 261 and 258): the padded convolution
    is the unpadded one within float32 rounding, and a residual that is a
    frame's slice of a window reaches C contiguous."""
    seen = {}

    def fake(x, weight, bias, **k):
        seen.update(x=x, weight=weight, residual=k["residual"])
        return conv.conv_plain(x, weight, bias, k["residual"])
    monkeypatch.setattr(conv, "conv3x3", fake)
    layer = torch.nn.Conv2d(cin, 128, 3, padding=1)
    x = _map(21, 2, 5, 7, cin)
    window = torch.randn((2, 3, 5, 7, 128),
                         generator=torch.Generator().manual_seed(22))
    got = feat_prop.conv3x3(x.as_subclass(_Cuda), layer,
                            residual=window[:, 1])
    pad = -cin % 4
    assert seen["x"].shape[-1] == cin + pad and seen["x"].is_contiguous()
    assert seen["weight"].shape[1] == cin + pad
    assert not seen["x"][..., cin:].any()
    assert not seen["weight"][:, cin:].any()
    assert seen["residual"].is_contiguous()
    want = window[:, 1] + conv2d(x, layer.weight, layer.bias, padding=1)
    assert (got - want).abs().max() <= 1e-5
