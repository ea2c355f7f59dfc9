"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests skip where CUDA is absent.
On a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

(chip_smoke.py runs the same checks at serving shapes.)
"""

import numpy as np
import pytest
import torch

from e2fgvi_tpu_torch.kernels import band_attention as ba
from e2fgvi_tpu_torch.kernels import band_sampler as bs
from e2fgvi_tpu_torch.kernels import conv
from e2fgvi_tpu_torch.kernels import deform
from e2fgvi_tpu_torch.kernels import focal_attention as fa
from e2fgvi_tpu_torch.kernels import gather

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from e2fgvi_tpu_torch.utils import env
    env.setup()
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, std=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * std


def _k1_inputs(gen, dtype, n, h, w, cin, g):
    x = _randn(gen, n, h, w, cin).to(dtype)
    head = _randn(gen, n, h, w, 27 * g).to(dtype)
    f1, f2 = _randn(gen, n, h, w, 2, std=4), _randn(gen, n, h, w, 2, std=4)
    f2[:, :, -3:, 0] += 60.0            # samples far outside the image
    wt = _randn(gen, 128, cin, 3, 3, std=0.05).to(dtype)
    b = _randn(gen, 128).to(dtype)
    return x, head, f1, f2, wt, b


def _check_k1(inputs, dtype):
    x, head, f1, f2, wt, b = inputs
    before = deform.LAUNCHES["deform_conv"]
    got = deform.modulated_deform_conv2d_head(x, head, f1, f2, wt, b)
    assert deform.LAUNCHES["deform_conv"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape[:3] + (128,)
    want = deform.deform_conv_head_plain(x.float(), head.float(), f1, f2,
                                         wt.float(), b.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        # 3xTF32 keeps float32 accuracy; one TF32 pass is ~1e-3 off (the
        # bar is chip_smoke.F32_MAX_ABS's)
        assert (got - want).abs().max() <= 2e-5
    else:
        assert torch.isfinite(got.float()).all()
        assert (got.float() - want).abs().max() / want.abs().max() < 2e-2


# (n, h, w): M = 234 pixels is no multiple of the fused kernel's 128-row
# tile; M = 35 is under one tile
@pytest.mark.parametrize("size", [(2, 9, 13), (1, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv_matches_plain(gen, dtype, size):
    """K1 (one fused kernel in both dtypes) at ragged map sizes."""
    _check_k1(_k1_inputs(gen, dtype, *size, cin=64, g=4), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_fused_serving_widths(gen, dtype):
    """The kernels' serving instantiation (Cin 256, G 16, Cout 128: 36
    64-wide K chunks in bf16, 72 32-wide in float32) on a map of a few
    rows, 6 tiles with a ragged last."""
    _check_k1(_k1_inputs(gen, dtype, 2, 3, 108, cin=256, g=16), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_fused_refuses_other_shapes(gen, dtype):
    x, head, f1, f2, wt, b = _k1_inputs(gen, dtype, 1, 5, 7, 64, 4)
    with pytest.raises(ValueError, match="Cout == 128"):
        deform.modulated_deform_conv2d_head(x, head, f1, f2, wt[:16], b[:16])
    x4 = _randn(gen, 1, 5, 7, 16).to(dtype)      # CG 4
    with pytest.raises(ValueError, match="CG == 16"):
        deform.modulated_deform_conv2d_head(x4, head, f1, f2, wt[:, :16],
                                            b)
    with pytest.raises(ValueError, match="device"):
        deform.modulated_deform_conv2d_head(x, head, f1, f2, wt.cpu(), b)
    # G = 1: G*K = 9, no whole K chunk in either dtype
    x1, head1, *_ = _k1_inputs(gen, dtype, 1, 5, 7, 16, 1)
    with pytest.raises(ValueError, match="even" if dtype == torch.float32
                       else "multiple of 4"):
        deform.modulated_deform_conv2d_head(x1, head1, f1, f2, wt[:, :16], b)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError, match="operands"):
        deform.modulated_deform_conv2d_head(
            x, head, f1, f2, wt, b,
            operands=deform.conv_operands(wt, b, other))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_fused_misaligned_and_operands(gen, dtype):
    """A view of x that is not 16-byte aligned is copied to an aligned
    tensor; operands made once (conv_operands) give the bits of operands
    made per call."""
    x, head, f1, f2, wt, b = _k1_inputs(gen, dtype, 1, 5, 7, 64, 4)
    want = deform.modulated_deform_conv2d_head(x, head, f1, f2, wt, b)
    big = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xm = big[1:].view(x.shape).copy_(x)
    assert xm.data_ptr() % 16
    assert torch.equal(
        deform.modulated_deform_conv2d_head(xm, head, f1, f2, wt, b), want)
    ops = deform.conv_operands(wt, b, dtype)
    assert torch.equal(deform.modulated_deform_conv2d_head(
        x, head, f1, f2, wt, b, operands=ops), want)


# (C, dtype, misaligned): a misaligned x is a view 1 element into a larger
# tensor, so K2 takes the narrower loads of the same kernel, and must give
# the bits of the aligned copy
_WARP_CASES = {"c2": (2, torch.float32, False),
               "c24": (24, torch.float32, False),
               "c128": (128, torch.float32, False),
               "c128_bf16": (128, torch.bfloat16, False),
               "c128_misaligned": (128, torch.float32, True),
               "c24_bf16_misaligned": (24, torch.bfloat16, True)}


@pytest.mark.parametrize("case", list(_WARP_CASES))
def test_flow_warp_matches_plain(gen, case):
    c, dtype, misaligned = _WARP_CASES[case]
    x = _randn(gen, 3, 11, 17, c).to(dtype)
    flow = _randn(gen, 3, 11, 17, 2, std=5)
    if misaligned:
        big = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        xm = big[1:].view(x.shape).copy_(x)
        assert xm.data_ptr() % 16
        assert torch.equal(deform.flow_warp(xm, flow),
                           deform.flow_warp(x, flow))
    got = deform.flow_warp(x, flow)
    assert got.dtype == dtype
    _assert_close_to_plain(got, deform.flow_warp_plain(x.float(), flow),
                           dtype, (1e-5, 1e-4), 2e-2)


def _k3_inputs(gen, dtype, b, heads, nwin, nq, no, t, s):
    """q and one key panel [own no | gathered t*s] per (b, head, window);
    the bias row per (b, window) is zero but for a few -100 keys (the
    caller adds its padding frames)."""
    nk = no + t * s
    q = _randn(gen, b * heads * nwin, nq, 128, std=128 ** -0.5).to(dtype)
    k, v = (_randn(gen, b * heads * nwin, nk, 128).to(dtype)
            for _ in range(2))
    bias = torch.zeros((b * nwin, nk), device="cuda")
    bias[:, no + 5:no + 9] = -100.0
    return q, k, v, bias


def _check_k3(q, k, v, bias, b, heads, dtype):
    before = fa.LAUNCHES["focal_attention"]
    got = fa.focal_attention(q, k, v, bias, b, heads)
    assert fa.LAUNCHES["focal_attention"] == before + 1
    want = fa.focal_attention_plain(q.float(), k.float(), v.float(), bias,
                                    b, heads)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        # 3xTF32 keeps float32 accuracy; one TF32 pass would be ~1e-4 off
        assert (got - want).abs().max() <= 1e-5
    else:
        assert torch.isfinite(got.float()).all()
        assert (got.float() - want).abs().max() / want.abs().max() < 5e-2


# (nq, no, t, s, padded frames): ragged tiles; a panel that ends one key
# into a key tile (no + t*s = 194: two keys into a 32-key float32 tile;
# 129: one past a 128-key bf16 tile and a 32-key float32 one); one query,
# and one past a query block (128 rows);
# every frame padded but the last (own keys 45 per frame), so the first
# key tiles of each panel are all padding
_K3_CASES = {"ragged": (70, 70, 3, 37, "last"),
             "one_key_into_tile": (70, 65, 3, 43, "last"),
             "nq_1": (1, 70, 3, 37, "last"),
             "nq_65": (65, 70, 3, 37, "last"),
             "nq_129": (129, 70, 3, 37, "last"),
             "all_but_one_padded": (135, 135, 3, 37, "all_but_last"),
             "one_key_into_bf16_tile": (129, 45, 3, 28, "last")}


@pytest.mark.parametrize("case", list(_K3_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_focal_attention_matches_plain(gen, dtype, case):
    nq, no, t, s, padded = _K3_CASES[case]
    b, heads, nwin = 2, 2, 3
    q, k, v, bias = _k3_inputs(gen, dtype, b, heads, nwin, nq, no, t, s)
    if padded == "last":
        bias[nwin:, no - 20:no] = -1e9      # the second batch element
        bias[:, -s:] = -1e9
    else:
        bias[:, :no - 45] = -1e9
        bias[:, no:-s] = -1e9
    _check_k3(q, k, v, bias, b, heads, dtype)


@pytest.mark.parametrize("s", [125, 149, 153])
@pytest.mark.parametrize("b", [1, 14])
def test_focal_attention_bf16_one_valid_frame(gen, b, s):
    """The bf16 kernel at the three serving key counts per frame (base,
    HQ 864x480, 1296x720) and T=17, on windows whose padding frames leave
    one frame valid: the first in window 0 of each batch element, the last
    in window 1."""
    t, nwin, heads = 17, 2, 4
    nq = t * 45
    q, k, v, bias = _k3_inputs(gen, torch.bfloat16, b, heads, nwin, nq, nq,
                               t, s)
    keep = torch.zeros((b * nwin, t), dtype=torch.bool, device="cuda")
    keep[::2, 0] = True
    keep[1::2, -1] = True
    keep = torch.cat([keep.repeat_interleave(45, 1),
                      keep.repeat_interleave(s, 1)], 1)
    bias = torch.where(keep, bias, torch.full_like(bias, -1e9))
    _check_k3(q, k, v, bias, b, heads, torch.bfloat16)


@pytest.mark.parametrize("s", [125, 149, 153])
def test_focal_attention_f32_serving_geometry(gen, s):
    """The float32 kernel (3xTF32 on wgmma, 128-query blocks, 32-key tiles)
    at the three serving key counts per frame (base, HQ 864x480,
    1296x720) and T=17: 765 queries over 6 blocks, 765 + 17 S keys, the
    last tile ragged; the second batch element's last 3 frames padded.
    Within 1e-5 of the plain version."""
    t, nwin, heads, b = 17, 2, 4, 2
    nq = t * 45
    q, k, v, bias = _k3_inputs(gen, torch.float32, b, heads, nwin, nq, nq,
                               t, s)
    keep = torch.ones((b * nwin, t), dtype=torch.bool, device="cuda")
    keep[nwin:, -3:] = False
    keep = torch.cat([keep.repeat_interleave(45, 1),
                      keep.repeat_interleave(s, 1)], 1)
    bias = torch.where(keep, bias, torch.full_like(bias, -1e9))
    _check_k3(q, k, v, bias, b, heads, torch.float32)


# ---------------------------------------------------------------------------
# K1-K3 at the HQ model's geometry: a 60x216 quarter-res map, whose 20x72
# token grid has 32 windows and S = 141 deduplicated keys (the base model
# only reaches 60x108, 16 windows, S = 125)
# ---------------------------------------------------------------------------

def _assert_close_to_plain(got, want, dtype, f32_tol, bf16_rel, f32_max=None):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=f32_tol[0],
                                   atol=f32_tol[1])
        if f32_max is not None:
            assert (got - want).abs().max() <= f32_max
    else:
        assert (got.float() - want).abs().max() / want.abs().max() < bf16_rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hq_deform_kernels_match_plain(gen, dtype):
    n, h, w = 2, 60, 216
    x = _randn(gen, n, h, w, 256).to(dtype)
    head = _randn(gen, n, h, w, 432).to(dtype)
    f1, f2 = _randn(gen, n, h, w, 2, std=4), _randn(gen, n, h, w, 2, std=4)
    f2[:, :, -8:, 0] += 60.0
    wt = _randn(gen, 128, 256, 3, 3, std=0.02).to(dtype)
    b = _randn(gen, 128, std=0.1).to(dtype)
    got = deform.modulated_deform_conv2d_head(x, head, f1, f2, wt, b)
    want = deform.deform_conv_head_plain(x.float(), head.float(), f1, f2,
                                         wt.float(), b.float())
    _assert_close_to_plain(got, want, dtype, (1e-5, 1e-4), 2e-2, 2e-5)
    feat = _randn(gen, 2 * n, h, w, 128).to(dtype)
    flow = torch.cat([f1, f2], 0)
    _assert_close_to_plain(deform.flow_warp(feat, flow),
                           deform.flow_warp_plain(feat.float(), flow),
                           dtype, (1e-5, 1e-4), 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hq_focal_attention_matches_plain(gen, dtype):
    from e2fgvi_tpu_torch.models import tfocal
    b, t, heads, hd = 2, 4, 4, 128
    fh, fw = tfocal.token_grid((60, 216))
    _, bias_rows, s = tfocal._window_tables(fh, fw, 5, 9, 2, 4, 4, 8, t,
                                            torch.device("cuda"))
    nwin, nq = (fh // 5) * (fw // 9), t * 45
    assert (fh, fw, nwin, s) == (20, 72, 32, 141)
    fv = torch.ones((b, t), dtype=torch.bool, device="cuda")
    fv[0, 2] = False                    # an end-padded window
    bias_g = bias_rows[None, :, None, :].expand(b, nwin, t, s)
    bias_g = torch.where(fv[:, None, :, None], bias_g, -1e9)
    bias_o = torch.where(fv, 0.0, -1e9)[:, None, :, None].expand(
        b, nwin, t, 45)
    bias = torch.cat([bias_o.reshape(b, nwin, nq),
                      bias_g.reshape(b, nwin, t * s)], -1)
    bias = bias.reshape(b * nwin, -1).contiguous()
    q = _randn(gen, b * heads * nwin, nq, hd, std=hd ** -0.5).to(dtype)
    k, v = (_randn(gen, b * heads * nwin, nq + t * s, hd).to(dtype)
            for _ in range(2))
    got = fa.focal_attention(q, k, v, bias, b, heads)
    want = fa.focal_attention_plain(q.float(), k.float(), v.float(), bias,
                                    b, heads)
    _assert_close_to_plain(got, want, dtype, (2e-4, 2e-4), 5e-2, 1e-5)


def test_i3d_on_cuda_matches_cpu(gen):
    """VFID's I3D through cuDNN's 3-D convolutions (TF32 off) against the
    CPU, on a reference-layout state dict."""
    from e2fgvi_tpu_torch.models import i3d
    model = i3d.I3D()
    i3d.load_reference_state_dict(model, i3d.random_reference_state_dict(
        torch.Generator().manual_seed(0)))
    video = torch.rand((1, 19, 72, 128, 3),
                       generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = i3d.i3d_features(model.eval(), video)
        got = i3d.i3d_features(model.cuda(), video.cuda()).cpu()
    assert got.shape == (1, i3d.FEATURES)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_kernels_refuse_grad(gen):
    """A kernel launch is forward-only: the direct call refuses an input
    that requires grad and names the autograd Functions; with grad mode on
    the wrapper takes such an input through its Function; with grad mode
    off it launches directly, and so refuses it too."""
    x = _randn(gen, 1, 4, 5, 8).requires_grad_()
    flow = torch.zeros((1, 4, 5, 2), device="cuda")
    with pytest.raises(RuntimeError, match="forward-only.*autograd"):
        deform.flow_warp_kernel(x, flow)
    assert np.isfinite(deform.flow_warp(x.detach(), flow).cpu()).all()
    assert deform.flow_warp(x, flow).grad_fn is not None
    with torch.no_grad():
        assert deform.flow_warp(x.detach(), flow).grad_fn is None
        with pytest.raises(RuntimeError, match="forward-only"):
            deform.flow_warp(x, flow)


def _grads(fn, inputs, ct):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    fn(*leaves).backward(ct)
    return [t.grad for t in leaves]


def test_kernel_functions_give_the_plain_gradients(gen):
    """K1, K2 and K3 through their autograd Functions: one launch forward,
    the output the kernel's, and each input's gradient the plain version's
    VJP (recomputed from the saved inputs), float32, within 1e-5 (the
    backward's scatter-adds sum in an order that changes between runs)."""
    x, head, f1, f2, wt, b = _k1_inputs(gen, torch.float32, 2, 9, 13, 64, 4)
    ins = (x, head, f1, f2, wt, b)
    ct = _randn(gen, 2, 9, 13, 128)
    before = deform.LAUNCHES["deform_conv"]
    got = _grads(deform.modulated_deform_conv2d_head, ins, ct)
    assert deform.LAUNCHES["deform_conv"] == before + 1
    want = _grads(deform.deform_conv_head_plain, ins, ct)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)

    feat, flow = _randn(gen, 4, 9, 13, 128), torch.cat([f1, f2])
    ct = _randn(gen, 4, 9, 13, 128)
    before = deform.LAUNCHES["flow_warp"]
    got = _grads(deform.flow_warp, (feat, flow), ct)
    assert deform.LAUNCHES["flow_warp"] == before + 1
    want = _grads(deform.flow_warp_plain, (feat, flow), ct)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)

    q, k, v, bias = _k3_inputs(gen, torch.float32, 2, 2, 3, 70, 70, 3, 37)
    ct = _randn(gen, 6, 70, 256)
    before = fa.LAUNCHES["focal_attention"]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.focal_attention(*leaves, bias, 2, 2)
    assert fa.LAUNCHES["focal_attention"] == before + 1
    assert (out - fa.focal_attention_plain(q, k, v, bias, 2, 2)).abs(
    ).max() <= 1e-5
    out.backward(ct)
    want = _grads(lambda *a: fa.focal_attention_plain(*a, bias, 2, 2),
                  (q, k, v), ct)
    for t, w_ in zip(leaves, want):
        torch.testing.assert_close(t.grad, w_, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# C (kernels/conv.py conv3x3): feat_prop's float32 3x3 convolutions

# (Cin, Cout, epilogue) as feat_prop runs them: the offset head's four, the
# backbone's two (256 backward, 384 forward, then 128 with the residual)
_C1_CONVS = {"offset0": (388, 128, "leaky"), "offset1": (128, 128, "leaky"),
             "offset3": (128, 432, "none"), "backbone0": (256, 128, "leaky"),
             "backbone0_fwd": (384, 128, "leaky"),
             "backbone1": (128, 128, "residual")}
# C1 lands within 3.5e-6 of float64 at these shapes (outputs ~5), where
# cuDNN's float32 lands 1.4e-5 from it; one TF32 pass is ~1e-3 off. So C1
# is held to 1e-5 of float64, and to 3e-5 of the plain version (cuDNN
# float32, TF32 off), whose own error is most of that distance
# (chip_smoke.F32_MAX_ABS["conv3x3"]).
_C1_MAX_ABS_F64, _C1_MAX_ABS = 1e-5, 3e-5


def _c1_inputs(gen, n, h, w, cin, cout, epilogue):
    x = _randn(gen, n, h, w, cin)
    wt = _randn(gen, cout, cin, 3, 3, std=(9 * cin) ** -0.5)
    b = _randn(gen, cout, std=0.1)
    kw = {"negative_slope": 0.1} if epilogue == "leaky" else {}
    if epilogue == "residual":
        kw["residual"] = _randn(gen, n, h, w, cout)
    return x, wt, b, kw


def _c1_plain(x, wt, b, kw, dtype=torch.float32):
    r = kw.get("residual")
    slope = kw.get("negative_slope")
    return conv.conv_plain(x.to(dtype), wt.to(dtype), b.to(dtype),
                           None if r is None else r.to(dtype),
                           "none" if slope is None else "leaky", slope)


@pytest.mark.parametrize("conv_name", list(_C1_CONVS))
@pytest.mark.parametrize("size", [(1, 60, 108), (4, 60, 108),
                                  (1, 120, 216)])
def test_conv3x3_matches_conv2d_and_float64(gen, size, conv_name):
    """C1 at feat_prop's shapes (60x108 maps at N = 1 and 4, HQ's 120x216
    at N = 1), each with its epilogue: one launch, within its bars of
    F.conv2d with TF32 off and of float64."""
    x, wt, b, kw = _c1_inputs(gen, *size, *_C1_CONVS[conv_name])
    before = conv.LAUNCHES["conv3x3"]
    got = conv.conv3x3(x, wt, b, **kw)
    assert conv.LAUNCHES["conv3x3"] == before + 1
    assert got.shape == (*size, wt.shape[0]) and got.is_contiguous()
    assert not torch.backends.cudnn.allow_tf32
    assert (got - _c1_plain(x, wt, b, kw)).abs().max() <= _C1_MAX_ABS
    want64 = _c1_plain(x, wt, b, kw, torch.float64)
    assert (got.double() - want64).abs().max() <= _C1_MAX_ABS_F64


@pytest.mark.parametrize("epilogue", ["none", "leaky", "residual"])
def test_conv3x3_ragged_and_operands(gen, epilogue):
    """Maps no tile divides, a 4-channel last K chunk (Cin 36), and the
    432-wide output; operands made once give the bits of operands made
    per call, and a misaligned x is copied, with the same bits."""
    for cout in (128, 432):
        x, wt, b, kw = _c1_inputs(gen, 2, 13, 21, 36, cout, epilogue)
        want = conv.conv3x3(x, wt, b, **kw)
        want64 = _c1_plain(x, wt, b, kw, torch.float64)
        assert (want.double() - want64).abs().max() <= _C1_MAX_ABS_F64
        ops = conv.conv_operands(wt, b)
        assert torch.equal(conv.conv3x3(x, wt, b, operands=ops, **kw), want)
        big = torch.empty(x.numel() + 1, device="cuda")
        xm = big[1:].view(x.shape).copy_(x)
        assert xm.data_ptr() % 16
        assert torch.equal(conv.conv3x3(xm, wt, b, **kw), want)


def test_conv3x3_does_not_synchronize(gen):
    """Making C1's operands and launching it never waits for the device
    (no host index tensor is uploaded): feat_prop makes 12 operand sets a
    window batch."""
    x, wt, b, kw = _c1_inputs(gen, 1, 5, 7, 388, 128, "leaky")
    conv.conv3x3(x, wt, b, **kw)                 # the library is loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops = conv.conv_operands(wt, b)
        conv.conv3x3(x, wt, b, operands=ops, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_conv3x3_refuses_what_it_does_not_take(gen):
    """bfloat16 and shapes outside the contract (an odd Cout: the epilogue
    stores column pairs) raise ValueError for CUDA tensors too: no
    fallback to cuDNN."""
    x, wt, b, _ = _c1_inputs(gen, 1, 5, 7, 64, 128, "none")
    before = conv.LAUNCHES["conv3x3"]
    for bad in ((x.bfloat16(), wt.bfloat16(), b.bfloat16()),
                (x, wt[:95], b[:95]), (x[..., :62].contiguous(),
                                       wt[:, :62].contiguous(), b),
                (x.transpose(1, 2).contiguous().transpose(1, 2), wt, b)):
        with pytest.raises(ValueError):
            conv.conv3x3(*bad)
    with pytest.raises(ValueError):
        conv.conv3x3(x, wt, b, stride=2)
    with pytest.raises(ValueError, match="device"):
        conv.conv3x3(x, wt, b, operands=conv.conv_operands(wt.cpu(), b.cpu()))
    assert conv.LAUNCHES["conv3x3"] == before


def test_feat_prop_launches_c1_in_float32_only(gen):
    """bidirectional_propagation on the card: in float32 every 3x3
    convolution of the offset head and the backbone is one C1 launch (per
    direction 2 at the first step and 6 at each after it); in bfloat16
    none, and the float32 result is the plain chain's within C1's bars."""
    from e2fgvi_tpu_torch.models import feat_prop
    torch.manual_seed(0)
    module = feat_prop.FeatPropModule(128, 16).cuda()
    b, t, h, w = 1, 4, 12, 20
    x = _randn(gen, b, t, h, w, 128)
    fb, ff = _randn(gen, b, t - 1, h, w, 2), _randn(gen, b, t - 1, h, w, 2)
    with torch.no_grad():
        before = conv.LAUNCHES["conv3x3"]
        got = feat_prop.bidirectional_propagation(module, x, fb, ff)
        assert conv.LAUNCHES["conv3x3"] == before + 2 * (2 + 6 * (t - 1))
        m16 = feat_prop.FeatPropModule(128, 16).cuda().bfloat16()
        m16.load_state_dict(module.state_dict())
        before = conv.LAUNCHES["conv3x3"]
        feat_prop.bidirectional_propagation(m16, x.bfloat16(), fb, ff)
        assert conv.LAUNCHES["conv3x3"] == before
    assert torch.isfinite(got).all()


def test_conv3x3_function_gives_the_plain_gradients(gen):
    """C1 through its autograd Function: one launch forward, the kernel's
    output, and the plain version's VJP in x, the weight, the bias and the
    residual (cuDNN's float32 backward, recomputed from the saved
    inputs)."""
    x, wt, b, kw = _c1_inputs(gen, 2, 9, 13, 64, 128, "residual")
    r = kw["residual"]
    ct = _randn(gen, 2, 9, 13, 128)
    leaves = [t.detach().clone().requires_grad_() for t in (x, wt, b, r)]
    before = conv.LAUNCHES["conv3x3"]
    out = conv.conv3x3(leaves[0], leaves[1], leaves[2], residual=leaves[3])
    assert conv.LAUNCHES["conv3x3"] == before + 1
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), conv.conv3x3(x, wt, b, residual=r))
    out.backward(ct)
    want = _grads(lambda *a: conv.conv_plain(*a), (x, wt, b, r), ct)
    for t, w_ in zip(leaves, want):
        torch.testing.assert_close(t.grad, w_, rtol=1e-5, atol=1e-5)


def test_conv3x3_refuses_grad(gen):
    """A bare launch refuses an input that requires grad and names the
    autograd Functions; the wrapper takes it through Conv3x3, and with
    grad mode off launches directly, and so refuses it too."""
    x, wt, b, _ = _c1_inputs(gen, 1, 4, 5, 32, 128, "none")
    xg = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only.*autograd"):
        conv.launch(xg, conv.conv_operands(wt, b), counter="conv3x3")
    assert conv.conv3x3(xg, wt, b).grad_fn is not None
    with torch.no_grad():
        assert conv.conv3x3(x, wt, b).grad_fn is None
        with pytest.raises(RuntimeError, match="forward-only"):
            conv.conv3x3(xg, wt, b)


# ---------------------------------------------------------------------------
# C through encoder_conv: the E2FGVI encoder's stride-1 convolutions

# the grouped layers (Cin, Cout, groups), at 1/4 of 432x240
_ENC_GROUPED = [(640, 512, 2), (768, 384, 4), (640, 256, 8)]


def _encoder(gen, dtype=torch.float32):
    """An Encoder on the card with weights that keep its activations near
    unit scale (chip_smoke.encoder_weights)."""
    from chip_smoke import encoder_weights
    from e2fgvi_tpu_torch.models import e2fgvi
    return encoder_weights(e2fgvi.Encoder().cuda(), lambda *shape, std=1.0:
                           _randn(gen, *shape, std=std)).to(dtype)


def test_encoder_on_c_matches_cudnn_and_float64(gen):
    """The encoder on a float32 input under inference mode, at the serving
    pipeline's ENC_CHUNK frames of 432x240: the stride-1 layers on C (18
    launches), within C's bars of the cuDNN float32 path (TF32 off) and of
    float64. The stride-2 layers' cuDNN output reaches C contiguous."""
    from e2fgvi_tpu_torch.data.pipeline import ENC_CHUNK
    from e2fgvi_tpu_torch.ops.convs import conv2d
    enc = _encoder(gen)
    x = _randn(gen, ENC_CHUNK, 240, 432, 3)
    assert not torch.backends.cudnn.allow_tf32
    with torch.inference_mode():
        for i in (0, 2):
            m = enc.layers[2 * i]
            xi = _randn(gen, 2, 24, 40, m.weight.shape[1])
            assert conv2d(xi, m.weight, m.bias, stride=2,
                          padding=1).is_contiguous()
        before = conv.LAUNCHES["encoder"]
        got = enc(x)
        assert conv.LAUNCHES["encoder"] == before + 18
        assert got.shape == (ENC_CHUNK, 60, 108, 128) and got.is_contiguous()
        enc.kernel_operands = lambda x: {}          # every layer on cuDNN
        want = enc(x)
    enc.double()
    with torch.inference_mode():
        want64 = enc(x.double())
    assert conv.LAUNCHES["encoder"] == before + 18
    assert (got - want).abs().max() <= _C1_MAX_ABS
    assert (got.double() - want64).abs().max() <= _C1_MAX_ABS_F64


@pytest.mark.parametrize("cin,cout,groups", _ENC_GROUPED)
def test_encoder_grouped_layer_matches_grouped_conv2d(gen, cin, cout,
                                                      groups):
    """A grouped layer alone through encoder_conv, one launch a group on
    channel ranges of one input and one output, against
    F.conv2d(groups=groups) and LeakyReLU(0.2) with TF32 off and in
    float64, at ENC_CHUNK maps of 60x108."""
    import torch.nn.functional as F
    from e2fgvi_tpu_torch.data.pipeline import ENC_CHUNK
    x = _randn(gen, ENC_CHUNK, 60, 108, cin)
    wt = _randn(gen, cout, cin // groups, 3, 3,
                std=(9 * cin / groups) ** -0.5)
    b = _randn(gen, cout, std=0.1)
    before = conv.LAUNCHES["encoder"]
    got = conv.encoder_conv(x, conv.group_operands(wt, b, groups), 0.2)
    assert conv.LAUNCHES["encoder"] == before + groups

    def grouped(dtype):
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), wt.to(dtype),
                     b.to(dtype), padding=1, groups=groups)
        return F.leaky_relu(y, 0.2).permute(0, 2, 3, 1)
    assert (got - grouped(torch.float32)).abs().max() <= _C1_MAX_ABS
    assert (got.double() - grouped(torch.float64)).abs().max() <= \
        _C1_MAX_ABS_F64


def test_encoder_launches_c_in_float32_only(gen):
    """LAUNCHES["encoder"] takes 18 an encoder call in float32 outside
    autograd, none in bfloat16 and none under grad (training)."""
    enc, enc16 = _encoder(gen), _encoder(gen, torch.bfloat16)
    x = _randn(gen, 3, 24, 40, 3)
    before = conv.LAUNCHES["encoder"]
    with torch.inference_mode():
        enc(x)
        assert conv.LAUNCHES["encoder"] == before + 18
        enc16(x.bfloat16())
    with torch.no_grad():
        enc(x)
    assert conv.LAUNCHES["encoder"] == before + 36
    assert enc(x).requires_grad
    assert conv.LAUNCHES["encoder"] == before + 36


# ---------------------------------------------------------------------------
# E1-E6: the experiments' kernels at small ragged shapes
# ---------------------------------------------------------------------------

def _band_inputs(gen, dtype, ng=3, k=2, cg=6, hp=7, wp=19, band=8):
    """Positions that leave the band and the image."""
    src = _randn(gen, ng, cg, hp + band, wp).to(dtype)
    rows = torch.arange(hp, dtype=torch.float32, device="cuda")[:, None]
    py = rows + (torch.rand((ng, k, hp, wp), generator=gen, device="cuda")
                 * 2 - 1) * band
    px = torch.rand((ng, k, hp, wp), generator=gen, device="cuda") \
        * (wp + 6) - 3
    mask = torch.rand((ng, k, hp, wp), generator=gen, device="cuda")
    return src, py, px, mask, -(band // 2)


def _close_bf16(got, want):
    """Within one bfloat16 ulp of a bfloat16-rounded plain result."""
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-6)


# the staged E5/E6 kernel's geometries: the ragged width (x one position a
# thread, 2-byte row pitches that no 16-byte copy lines up with), an aligned
# 128-wide tile, band 24 with HP = 21 (no multiple of the plan's tile
# height), and exp_dcn_pack's band 48, where a float32 source takes several
# channel chunks, double-buffered
_SAMPLER_GEOMS = {
    "ragged": dict(ng=3, k=2, cg=6, hp=7, wp=19, band=8),
    "aligned": dict(ng=2, k=3, cg=8, hp=16, wp=128, band=8),
    "band24": dict(ng=2, k=3, cg=16, hp=21, wp=128, band=24),
    "band48": dict(ng=2, k=2, cg=16, hp=64, wp=128, band=48),
}


@pytest.mark.parametrize("geom", list(_SAMPLER_GEOMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cbatch", [False, True])
def test_band_sample_matches_plain(gen, dtype, cbatch, geom):
    g = _SAMPLER_GEOMS[geom]
    inputs = _band_inputs(gen, dtype, **g)
    plan = bs.plan(g["cg"], g["hp"], g["wp"], g["band"],
                   inputs[0].element_size())
    if geom == "band24":
        assert g["hp"] % plan.ty
    if geom == "band48" and dtype == torch.float32:
        assert plan.nchunks > 1
    kernel = bs.band_sample_cbatch if cbatch else bs.band_sample
    plain = bs.band_sample_cbatch_plain if cbatch else bs.band_sample_plain
    name = "band_sample_cbatch" if cbatch else "band_sample"
    before = bs.LAUNCHES[name]
    got = kernel(*inputs)
    assert bs.LAUNCHES[name] == before + 1
    want = plain(*inputs)
    assert got.dtype == dtype and want.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("geom", list(_SAMPLER_GEOMS))
def test_packed_band_samplers_bit_equal_base(gen, geom):
    src, *rest = _band_inputs(gen, torch.bfloat16, **_SAMPLER_GEOMS[geom])
    base = bs.band_sample(src, *rest)
    assert torch.equal(bs.band_sample(src.float(), *rest,
                                      out_dtype=torch.bfloat16), base)
    assert torch.equal(bs.band_sample_xpair(bs.pack_xpairs(src), *rest),
                       base)
    before = bs.LAUNCHES["band_sample_cpair"]
    assert torch.equal(bs.band_sample_cpair(bs.pack_cpairs(src), *rest),
                       base)
    assert bs.LAUNCHES["band_sample_cpair"] == before + 1
    # the packers agree with their CPU versions
    assert torch.equal(bs.pack_xpairs(src).cpu(), bs.pack_xpairs(src.cpu()))
    assert torch.equal(bs.pack_cpairs(src).cpu(), bs.pack_cpairs(src.cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_matches_plain(gen, dtype):
    p, c = 37, 24
    tab = _randn(gen, p, c).to(dtype)
    idx = torch.randint(0, p, (3, 5, c), generator=gen, device="cuda",
                        dtype=torch.int32)
    got = gather.row_gather(tab, idx)
    assert got.dtype == dtype
    assert torch.equal(got, gather.row_gather_plain(tab, idx))


def _row_idx(gen, kind, t, p, c, rows):
    """(t, p, c) int32 indices into `rows` table rows: one row for each
    8-lane group (`shared`), one a lane (`per_lane`), or both in every row
    (`mixed`)."""
    def draw(*shape):
        return torch.randint(0, rows, shape, generator=gen, device="cuda",
                             dtype=torch.int32)
    shared = draw(t, p, (c + 7) // 8).repeat_interleave(8, -1)[..., :c]
    if kind == "shared":
        return shared.contiguous()
    per_lane = draw(t, p, c)
    if kind == "per_lane":
        return per_lane
    even = (torch.arange(c, device="cuda") // 8) % 2 == 0
    return torch.where(even, shared, per_lane)


def _check_row_gather(tab, idx, want=None):
    before = gather.LAUNCHES["row_gather"]
    got = gather.row_gather(tab, idx)
    assert gather.LAUNCHES["row_gather"] == before + 1
    assert got.dtype == tab.dtype and got.shape == idx.shape
    if want is None:
        want = gather.row_gather_plain(tab, idx)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["shared", "per_lane", "mixed"])
def test_row_gather_experiment_shape(gen, kind, dtype):
    """E3 at the experiment's (9, 6480, 128): the one-read path where a
    group's 8 lanes share a row, the lane-by-lane one, and both in a row."""
    tab = _randn(gen, 6480, 128).to(dtype)
    _check_row_gather(tab, _row_idx(gen, kind, 9, 6480, 128, 6480))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_out_of_range_is_zero(gen, dtype):
    p, c = 37, 32
    tab = _randn(gen, p, c).to(dtype)
    idx = _row_idx(gen, "shared", 3, 5, c, p)
    idx[0, :, 3] = -1                       # one lane of a group
    idx[1, :, 8:16] = p                     # a whole group
    idx[2, ::2, -1] = 2 ** 31 - 1
    inside = (idx >= 0) & (idx < p)
    want = torch.where(inside, gather.row_gather_plain(
        tab, torch.where(inside, idx, 0)), 0).to(dtype)
    _check_row_gather(tab, idx, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["shared", "per_lane"])
def test_row_gather_c20_and_misaligned_views(gen, kind, dtype):
    """C = 20 (4 lanes a thread), and tab and idx as views 1 element into
    larger tensors (narrower loads), each against the plain version."""
    p, c = 37, 20
    tab = _randn(gen, p, c).to(dtype)
    idx = _row_idx(gen, kind, 3, 5, c, p)
    _check_row_gather(tab, idx)
    big = torch.empty(tab.numel() + 1, dtype=dtype, device="cuda")
    tab_view = big[1:].view(tab.shape).copy_(tab)
    bigi = torch.empty(idx.numel() + 1, dtype=torch.int32, device="cuda")
    idx_view = bigi[1:].view(idx.shape).copy_(idx)
    assert tab_view.data_ptr() % 16 and idx_view.data_ptr() % 16
    tab128 = _randn(gen, p, 128).to(dtype)
    idx128 = _row_idx(gen, kind, 3, 5, 128, p)
    big = torch.empty(tab128.numel() + 1, dtype=dtype, device="cuda")
    tab128_view = big[1:].view(tab128.shape).copy_(tab128)
    for t, i in ((tab_view, idx), (tab, idx_view), (tab_view, idx_view),
                 (tab128_view, idx128)):
        _check_row_gather(t, i)


def test_row_gather_wide_offsets(gen):
    """A table of more than 2**31 elements (bfloat16, 4.3 GB) takes the
    kernel's 64-bit offsets: rows near its end read right."""
    c = 128
    rows = 2 ** 31 // c + 64
    tab = torch.empty((rows, c), dtype=torch.bfloat16, device="cuda")
    tab[-64:] = _randn(gen, 64, c).to(torch.bfloat16)
    for kind in ("shared", "per_lane"):
        idx = _row_idx(gen, kind, 2, 7, c, 64) + (rows - 64)
        _check_row_gather(tab, idx)
    del tab
    torch.cuda.empty_cache()


# (h, w, C, G, rows a tap, misaligned tab): C/G = 8 takes 16-byte corner
# loads, C/G = 3 scalar ones; 37 and 13 rows are no multiple of a block's
_BILINEAR_CASES = {"cg8": (60, 108, 128, 16, 6480, False),
                   "cg8_ragged": (7, 11, 64, 8, 37, False),
                   "cg3": (7, 11, 24, 8, 13, False),
                   "cg8_misaligned": (7, 11, 128, 16, 37, True),
                   "cg3_misaligned": (7, 11, 24, 8, 13, True)}


@pytest.mark.parametrize("case", list(_BILINEAR_CASES))
def test_bilinear4_group_major_matches_plain(gen, case):
    """E4 within 1e-6 of its plain version, positions past the map's edges
    (clamped corners); and at whole-pixel positions, where each lane is one
    table entry, equal to the table read through its group-major rewrite:
    lane j of a row is tab[y*w + x, j] at group j % G's (y, x)."""
    h, w, c, g, p, misaligned = _BILINEAR_CASES[case]
    tab = _randn(gen, h * w, c)
    py = torch.rand((2, p, g), generator=gen, device="cuda") * (h + 3) - 2
    px = torch.rand((2, p, g), generator=gen, device="cuda") * (w + 3) - 2
    if misaligned:
        big = torch.empty(tab.numel() + 1, device="cuda")
        tab = big[1:].view(tab.shape).copy_(tab)
        assert tab.data_ptr() % 16
    before = gather.LAUNCHES["bilinear4_sample"]
    got = gather.bilinear4_sample(tab, py, px, h, w)
    assert gather.LAUNCHES["bilinear4_sample"] == before + 1
    torch.testing.assert_close(got, gather.bilinear4_sample_plain(
        tab, py, px, h, w), rtol=1e-6, atol=1e-6)
    assert torch.equal(gather.bilinear4_sample(tab, py, px, h, w), got)
    iy = torch.randint(0, h, (2, p, g), generator=gen, device="cuda")
    ix = torch.randint(0, w, (2, p, g), generator=gen, device="cuda")
    whole = gather.bilinear4_sample(tab, iy.float(), ix.float(), h, w)
    pix = (iy * w + ix).repeat(1, 1, c // g)        # lane j: group j % G
    assert torch.equal(whole, tab[pix, torch.arange(c, device="cuda")])
    tabg = gather.group_major_plain(tab, g)
    assert torch.equal(tabg, tab.reshape(h * w, c // g, g).permute(2, 0, 1)
                       .contiguous())


def test_bilinear4_refuses_what_it_does_not_take(gen):
    tab = _randn(gen, 6, 8)
    pos = torch.zeros((1, 2, 4), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        gather.bilinear4_sample(tab.bfloat16(), pos, pos, 2, 3)
    with pytest.raises(ValueError, match="do not fit"):
        gather.bilinear4_sample(tab, pos[..., :3], pos[..., :3], 2, 3)
    with pytest.raises(ValueError, match="C <="):
        gather.bilinear4_sample(_randn(gen, 6, 2048), pos, pos, 2, 3)


def test_bilinear4_matches_plain(gen):
    h, w, c, g = 7, 11, 24, 8
    tab = _randn(gen, h * w, c)
    py = torch.rand((2, 13, g), generator=gen, device="cuda") * (h + 3) - 2
    px = torch.rand((2, 13, g), generator=gen, device="cuda") * (w + 3) - 2
    torch.testing.assert_close(gather.bilinear4_sample(tab, py, px, h, w),
                               gather.bilinear4_sample_plain(tab, py, px, h,
                                                             w),
                               rtol=1e-6, atol=1e-6)


def _attn_block(gen, b=2, t=3, h=10, w=18, c=256):
    from e2fgvi_tpu_torch.models import tfocal
    block = tfocal.TemporalFocalTransformerBlock(c, (5, 9), 64)
    block.init_weights(torch.Generator().manual_seed(1))
    block = block.cuda().to(torch.bfloat16).requires_grad_(False)
    x = _randn(gen, b, t, h, w, c).to(torch.bfloat16)
    return block, x, tfocal._pool_level(block, x, (5, 9))


# (b, t, h, w, C, heads): ragged query and key tiles with the wrap at both
# edges; one frame; the serving geometry (20x36 tokens, 16 windows) at b=1
_BAND_GEOMS = {"b2_t3_10x18": (2, 3, 10, 18, 256, 2),
               "t1": (2, 1, 10, 18, 256, 2),
               "serving_b1": (1, 17, 20, 36, 512, 4)}


@pytest.mark.parametrize("frame_valid", ["none", "partial", "element"])
@pytest.mark.parametrize("geom", list(_BAND_GEOMS))
def test_band_attention_matches_plain_and_k3(gen, geom, frame_valid):
    """The kernel within 5e-2 of the scale of its plain version and of K3's
    layer over the queries of valid frames. "element": batch element 0 has
    no valid frame; its outputs (every key -1e9: a uniform softmax over
    the undeduplicated keys, which K3's deduplicated panel does not share)
    must be finite and equal the plain version's."""
    from e2fgvi_tpu_torch.models import tfocal
    b, t, h, w, c, heads = _BAND_GEOMS[geom]
    block, x, pooled = _attn_block(gen, b, t, h, w, c)
    fv = None
    if frame_valid != "none":
        fv = torch.ones((b, t), dtype=torch.bool, device="cuda")
        if frame_valid == "element":
            fv[0] = False
        else:
            fv[0, -1] = False
            fv[-1, :max(t - 2, 0)] = False
    args = (block.attn, x, pooled, heads, (5, 9), (2, 4))
    before = ba.LAUNCHES["band_attention"]
    got = ba.band_attention(*args, frame_valid=fv).float()
    assert ba.LAUNCHES["band_attention"] == before + 1
    assert torch.isfinite(got).all()
    want = ba.band_attention_plain(block.attn, x.float(), pooled.float(),
                                   *args[3:], frame_valid=fv).float()
    k3 = tfocal.window_attention(*args, frame_valid=fv).float()
    scale = want.abs().max()
    nwin = (h // 5) * (w // 9)
    if frame_valid == "element":
        assert (got[:nwin] - want[:nwin]).abs().max() / scale < 5e-2
    if fv is not None:
        valid = fv.repeat_interleave(45, 1).repeat_interleave(nwin, 0)
        got, want, k3 = (torch.where(valid[..., None], z, 0.0)
                         for z in (got, want, k3))
    assert (got - want).abs().max() / scale < 5e-2
    assert (got - k3).abs().max() / scale < 5e-2


def test_new_kernels_refuse_grad(gen):
    src, *rest = _band_inputs(gen, torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        bs.band_sample(src.requires_grad_(), *rest)
    with pytest.raises(RuntimeError, match="forward-only"):
        bs.band_sample_cbatch(src, *rest)
    py = rest[0].clone().requires_grad_()
    src16 = src.detach().bfloat16()
    with pytest.raises(RuntimeError, match="forward-only"):
        bs.band_sample_xpair(bs.pack_xpairs(src16), py, *rest[1:])
    with pytest.raises(RuntimeError, match="forward-only"):
        bs.band_sample_cpair(bs.pack_cpairs(src16), py, *rest[1:])
    tab = _randn(gen, 5, 8).requires_grad_()
    idx = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="forward-only"):
        gather.row_gather(tab, idx)
    with pytest.raises(RuntimeError, match="forward-only"):
        gather.bilinear4_sample(_randn(gen, 6, 8).requires_grad_(),
                                torch.zeros((1, 2, 4), device="cuda"),
                                torch.zeros((1, 2, 4), device="cuda"), 2, 3)
    block, x, pooled = _attn_block(gen)
    with pytest.raises(RuntimeError, match="forward-only"):
        ba.band_attention(block.attn, x.requires_grad_(), pooled, 2, (5, 9),
                          (2, 4))
