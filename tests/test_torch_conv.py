"""C1 (kernels/conv.py, csrc/conv.cu) on the CPU: its B operand (the
weight reordered, permuted and split into tf32 parts), the kernel's
schedule emulated in numpy (TMA's halo box with its zero fill and 128-byte
swizzle, each thread's loads and A fragments, the wgmma's k-columns, the
epilogue), its 3xTF32 precision, the wrapper's CPU path, and what the
wrapper refuses. The kernel itself runs in tests/test_torch_cuda.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from e2fgvi_tpu_torch.kernels import conv
from e2fgvi_tpu_torch.kernels.deform import split_tf32
from e2fgvi_tpu_torch.models import feat_prop
from e2fgvi_tpu_torch.ops.convs import conv2d, leaky_relu

SRC = (Path(conv.__file__).resolve().parents[1] / "csrc" / "conv.cu"
       ).read_text()
TW, TH = map(int, re.search(r"kTW = (\d+), kTH = (\d+);", SRC).groups())
BK = int(re.search(r"kBK = (\d+);", SRC).group(1))
HW, HH = TW + 2, TH + 2
# feat_prop's convolutions: (Cin, Cout)
SHAPES = [(388, 128), (128, 128), (128, 432), (256, 128), (384, 128)]
# a K chunk's column 8kk + j holds channel 8 (j % 4) + 2kk + j // 4 (the
# wgmma's k-step kk, k-column j: thread t of a quad hands k-step kk its
# channels 8t + 2kk and 8t + 2kk + 1)
CHANNEL_OF_COLUMN = [8 * (j % 4) + 2 * kk + j // 4
                     for kk in range(4) for j in range(8)]


def _inputs(seed, n, h, w, cin, cout, std=1.0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=gen) * std
    wt = torch.randn((cout, cin, 3, 3), generator=gen) * (cin * 9) ** -0.5
    b = torch.randn((cout,), generator=gen) * 0.1
    res = torch.randn((n, h, w, cout), generator=gen)
    return x, wt, b, res


@pytest.mark.parametrize("cin,cout", SHAPES + [(36, 128), (4, 432)])
def test_operands_rebuild_the_weight(cin, cout):
    """conv_operands' (2, Cout, 9 Cin_pad): chunk q = 9c + tap, column j
    is channel 32c + CHANNEL_OF_COLUMN[j] of that tap; big + small is the
    weight within 2^-22 of its scale, both tf32 (13 low bits zero), and
    the columns past Cin are zero."""
    _, wt, b, _ = _inputs(0, 1, 1, 1, cin, cout)
    wk, b32 = conv.conv_operands(wt, b)
    chunks = -(-cin // BK)
    assert wk.shape == (2, cout, 9 * chunks * BK) and wk.dtype == torch.float32
    assert torch.equal(b32, b)
    bits = wk.view(torch.int32)
    assert not (bits & 0x1FFF).any()
    perm = np.asarray(CHANNEL_OF_COLUMN)
    assert sorted(perm) == list(range(BK))
    rebuilt = torch.zeros((cout, chunks * BK, 3, 3), dtype=torch.float64)
    full = (wk[0].double() + wk[1].double()).reshape(cout, chunks, 9, BK)
    for c in range(chunks):
        for tap in range(9):
            rebuilt[:, c * BK + perm, tap // 3, tap % 3] = full[:, c, tap]
    assert not rebuilt[:, cin:].any()
    err = (rebuilt[:, :cin] - wt.double()).abs().max()
    assert err <= 2.0 ** -22 * wt.abs().max()
    big = wk[0].reshape(cout, chunks, 9, BK)
    assert torch.equal(big, split_tf32(conv.conv_weight(wt))[0].reshape(
        cout, chunks, 9, BK))


def _swizzled(rows):
    """Rows of 32 floats as TMA's 128-byte swizzle lays them in shared
    memory from a 1024-byte-aligned base: 16-byte chunk j of row r at
    chunk j ^ (r & 7). (rows, 8, 4)."""
    r = np.arange(rows.shape[0])[:, None]
    mem = np.empty((rows.shape[0], 8, 4), rows.dtype)
    mem[r, np.arange(8)[None] ^ (r & 7)] = rows.reshape(-1, 8, 4)
    return mem


def _padded(x):
    """x (N, H, W, Cin) inside zeros: one pixel before each map, a tile
    after, channels to whole chunks. Element (y + 1, x + 1) is x's (y,
    x)."""
    n, h, w, cin = x.shape
    xp = np.zeros((n, h + TH + 2, w + TW + 2, -(-cin // BK) * BK), x.dtype)
    xp[:, 1:h + 1, 1:w + 1, :cin] = x
    return xp


def _halo(xp, n, c, x0, y0):
    """TMA's box {32, 18, 10, 1} at (32c, x0 - 1, y0 - 1, n) of x as (C, W,
    H, N), elements outside x (the padding, channels past Cin) zeros:
    (10 * 18 rows in box order, 32)."""
    return xp[n, y0:y0 + HH, x0:x0 + HW, BK * c: BK * c + BK].reshape(
        HH * HW, BK)


# each consumer thread: warpgroup, warp, (g, t) of its quad, its tile row
_TID = np.arange(256)
_WG, _WARP, _LANE = _TID // 128, (_TID // 32) % 4, _TID % 32
_G, _T = _LANE // 4, _LANE % 4
_TY = 4 * _WG + _WARP
_ROW0 = 64 * _WG + 16 * _WARP + _G        # the thread's rows: _ROW0, + 8


def _a_tile(mem, ky, kx):
    """The (128, 32) A operand the warpgroups' fragments make of a halo
    for tap (ky, kx): each thread's two 16-byte loads of each of its rows
    (load_raw), then k-step kk's fragment (g, t) = channel 8t + 2kk of row
    g, (g + 8, t) of row g + 8, (g, t + 4) = channel 8t + 2kk + 1, ..."""
    v = np.empty((256, 16), mem.dtype)
    for r in range(2):
        hr = (_TY + ky) * HW + _G + 8 * r + kx
        for hf in range(2):
            v[:, 8 * r + 4 * hf: 8 * r + 4 * hf + 4] = \
                mem[hr, (2 * _T + hf) ^ (hr & 7)]
    a = np.empty((2 * 64, BK), mem.dtype)
    for kk in range(4):
        a[_ROW0, 8 * kk + _T] = v[:, 2 * kk]
        a[_ROW0 + 8, 8 * kk + _T] = v[:, 8 + 2 * kk]
        a[_ROW0, 8 * kk + _T + 4] = v[:, 2 * kk + 1]
        a[_ROW0 + 8, 8 * kk + _T + 4] = v[:, 9 + 2 * kk]
    return a


def _tf32_parts(a):
    big, small = split_tf32(torch.from_numpy(np.ascontiguousarray(a)))
    return big.numpy(), small.numpy()


def _emulate(x, operands, cout, negative_slope=None, residual=None,
             products=("sb", "bs", "bb")):
    """C1's schedule: a block per (16 x 8 tile, image, N-tile of 128 or
    144), chunk q = 9c + tap of the halo of channel chunk c; each chunk's
    products in float64, rounded to float32 as the tensor cores' float32
    accumulator, joining a float32 running sum; the epilogue's bias,
    LeakyReLU and residual on the pixels inside the map."""
    xs = x.numpy()
    xp = _padded(xs)
    wk = operands.weight.numpy()
    b32 = operands.bias.numpy()
    n_img, h, w, cin = xs.shape
    bn = 128 if cout == 128 else 144
    chunks = -(-cin // BK)
    out = np.full((n_img, h, w, cout), np.nan, np.float32)
    m = np.arange(TW * TH)
    for n in range(n_img):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                mems = [_swizzled(_halo(xp, n, c, x0, y0))
                        for c in range(chunks)]
                for n0 in range(0, cout, bn):
                    total = np.zeros((TW * TH, bn), np.float32)
                    for q in range(9 * chunks):
                        c, tap = divmod(q, 9)
                        ab, asm = _tf32_parts(_a_tile(mems[c], *divmod(tap,
                                                                      3)))
                        bb = wk[0, n0:n0 + bn, BK * q: BK * q + BK]
                        bs = wk[1, n0:n0 + bn, BK * q: BK * q + BK]
                        terms = {"sb": (asm, bb), "bs": (ab, bs),
                                 "bb": (ab, bb)}
                        acc = sum(a.astype(np.float64) @ b.T.astype(np.float64)
                                  for a, b in (terms[p] for p in products))
                        total += acc.astype(np.float32)
                    y, xx = y0 + m // TW, x0 + m % TW
                    keep = (y < h) & (xx < w)
                    v = total[keep] + b32[n0:n0 + bn]
                    if negative_slope is not None:
                        v = np.where(v > 0, v, v * np.float32(negative_slope))
                    if residual is not None:
                        v = residual.numpy()[n, y[keep], xx[keep],
                                             n0:n0 + bn] + v
                    out[n, y[keep], xx[keep], n0:n0 + bn] = v
    return out


EPILOGUES = {"none": {}, "leaky": {"negative_slope": 0.1},
             "residual": {"residual": True}}


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 10, 20, 36, 128),        # ragged tiles both ways, a 4-channel chunk
    (1, 8, 16, 64, 432),         # whole tiles; three 144-wide N-tiles
    (1, 9, 17, 388, 128)])       # the offset head's first layer
def test_kernel_schedule_matches_conv(n, h, w, cin, cout, epilogue):
    """The emulated schedule against the float64 convolution: every
    output pixel written once, each within 3xTF32's error."""
    x, wt, b, res = _inputs(1, n, h, w, cin, cout)
    kw = dict(EPILOGUES[epilogue])
    if "residual" in kw:
        kw["residual"] = res
    got = _emulate(x, conv.conv_operands(wt, b), cout, **kw)
    assert not np.isnan(got).any()
    want = conv.conv3x3_plain(
        x.double(), wt.double(), b.double(),
        None if "residual" not in kw else res.double(),
        kw.get("negative_slope")).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_3xtf32_keeps_float32_accuracy():
    """The precision argument: the three products, each chunk's summed
    from zero and joined by a float32 add, land as close to float64 as a
    float32 convolution does; one TF32 pass (big * big) does not."""
    x, wt, b, _ = _inputs(2, 1, 8, 16, 388, 128)
    ops = conv.conv_operands(wt, b)
    want = conv.conv3x3_plain(x.double(), wt.double(), b.double()).numpy()
    f32 = np.abs(conv.conv3x3_plain(x, wt, b).numpy() - want).max()
    three = np.abs(_emulate(x, ops, 128) - want).max()
    one = np.abs(_emulate(x, ops, 128, products=("bb",)) - want).max()
    assert three <= 2 * f32, (three, f32)
    assert one >= 20 * f32, (one, f32)


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
def test_cpu_path_is_conv2d_and_epilogue(epilogue):
    """On the CPU the wrapper is ops.convs.conv2d, then the epilogue,
    exactly, and launches nothing."""
    x, wt, b, res = _inputs(3, 2, 6, 11, 388, 432 if epilogue == "none"
                            else 128)
    before = conv.LAUNCHES["conv3x3"]
    want = conv2d(x, wt, b, padding=1)
    if epilogue == "leaky":
        got = conv.conv3x3(x, wt, b, negative_slope=0.1)
        want = leaky_relu(want, 0.1)
    elif epilogue == "residual":
        got = conv.conv3x3(x, wt, b, residual=res)
        want = res + want
    else:
        got = conv.conv3x3(x, wt, b)
    assert torch.equal(got, want)
    assert conv.LAUNCHES["conv3x3"] == before


def _refused(case):
    x, wt, b, _ = _inputs(4, 1, 5, 6, 128, 128)
    kw = {}
    if case == "bf16":
        x, wt = x.bfloat16(), wt.bfloat16()
    elif case == "stride":
        kw["stride"] = 2
    elif case == "kernel":
        wt = wt[..., :1, :1].contiguous()
    elif case == "cin":
        x, wt = x[..., :126].contiguous(), wt[:, :126].contiguous()
    elif case == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "cout":
        wt, b = wt[:64], b[:64]
    return x, wt, b, kw


@pytest.mark.parametrize("case", ["bf16", "stride", "kernel", "cin",
                                  "non_contiguous", "cout"])
def test_wrapper_refuses(case):
    """What C1 does not take raises ValueError, on every device: here on
    the CPU and on meta tensors (the device's checks come after), and the
    kernel's launcher itself."""
    x, wt, b, kw = _refused(case)
    with pytest.raises(ValueError):
        conv.conv3x3(x, wt, b, **kw)
    with pytest.raises(ValueError):
        conv.conv3x3(x.to("meta"), wt.to("meta"), b.to("meta"), **kw)
    if not kw:
        with pytest.raises(ValueError):
            conv.conv3x3_kernel(x, wt, b)


def test_feat_prop_routes_float32_cuda_convolutions_to_c1(monkeypatch):
    """feat_prop's dispatch by what it sees: a float32 CUDA tensor goes to
    C1 (conv3x3, with its operands), others to the plain chain. CUDA is
    stood in by a flag on the tensor."""
    calls = []
    monkeypatch.setattr(conv, "conv3x3", lambda x, *a, **k: calls.append(
        ("c1", x.dtype)) or conv.conv3x3_plain(x, *a[:2]))
    monkeypatch.setattr(conv, "conv3x3_plain", _recording(calls))

    class Cuda(torch.Tensor):
        is_cuda = True
    layer = torch.nn.Conv2d(8, 128, 3, padding=1)
    x = torch.randn(1, 4, 5, 8)
    feat_prop.conv3x3(x, layer)
    feat_prop.conv3x3(x.bfloat16(), layer.bfloat16())
    assert [c[0] for c in calls] == ["plain", "plain"]
    calls.clear()
    feat_prop.conv3x3(x.as_subclass(Cuda), layer.float())
    assert calls[0] == ("c1", torch.float32)
    assert feat_prop.conv3x3_operands([layer], x) == [None]


def _recording(calls):
    plain = conv.conv3x3_plain

    def record(x, *a, **k):
        calls.append(("plain", x.dtype))
        return plain(x, *a, **k)
    return record
