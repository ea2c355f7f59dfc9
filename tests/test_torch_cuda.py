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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_im2col_matches_plain(gen, dtype):
    n, h, w, cin, g = 2, 9, 13, 64, 4
    x = _randn(gen, n, h, w, cin).to(dtype)
    head = _randn(gen, n, h, w, 27 * g).to(dtype)
    f1, f2 = _randn(gen, n, h, w, 2, std=4), _randn(gen, n, h, w, 2, std=4)
    wt = _randn(gen, 16, cin, 3, 3, std=0.05).to(dtype)
    b = _randn(gen, 16).to(dtype)
    before = deform.LAUNCHES["deform_im2col"]
    got = deform.modulated_deform_conv2d_head(x, head, f1, f2, wt, b)
    assert deform.LAUNCHES["deform_im2col"] == before + 1
    want = deform.deform_conv_head_plain(x.float(), head.float(), f1, f2,
                                         wt.float(), b.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert (got.float() - want).abs().max() / want.abs().max() < 2e-2


@pytest.mark.parametrize("c", [2, 24, 128])
def test_flow_warp_matches_plain(gen, c):
    x = _randn(gen, 3, 11, 17, c)
    flow = _randn(gen, 3, 11, 17, 2, std=5)
    torch.testing.assert_close(deform.flow_warp(x, flow),
                               deform.flow_warp_plain(x, flow),
                               rtol=1e-5, atol=1e-4)


# (nq, no, t, s, padded frames): ragged tiles; a panel that ends one key
# into a 64-key tile (no 65, t*s 129); one query, and one past a query
# block (64 rows in bf16, 128 in float32); every frame padded but the last
# (own keys 45 per frame), so the first key tile of each panel is all
# padding
_K3_CASES = {"ragged": (70, 70, 3, 37, "last"),
             "one_key_into_tile": (70, 65, 3, 43, "last"),
             "nq_1": (1, 70, 3, 37, "last"),
             "nq_65": (65, 70, 3, 37, "last"),
             "nq_129": (129, 70, 3, 37, "last"),
             "all_but_one_padded": (135, 135, 3, 37, "all_but_last")}


@pytest.mark.parametrize("case", list(_K3_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_focal_attention_matches_plain(gen, dtype, case):
    nq, no, t, s, padded = _K3_CASES[case]
    b, heads, nwin, hd = 2, 2, 3, 128
    q = _randn(gen, b * heads * nwin, nq, hd, std=hd ** -0.5).to(dtype)
    ko, vo = (_randn(gen, b * heads * nwin, no, hd).to(dtype)
              for _ in range(2))
    kg, vg = (_randn(gen, b * heads, t, nwin, s, hd).to(dtype)
              for _ in range(2))
    bias_o = torch.zeros((b, 1, no), device="cuda")
    bias_g = torch.zeros((b * nwin, 1, t * s), device="cuda")
    bias_g[:, :, 5:9] = -100.0
    if padded == "last":
        bias_o[1, :, -20:] = -1e9
        bias_g[:, :, -s:] = -1e9
    else:
        bias_o[:, :, :-45] = -1e9
        bias_g[:, :, :-s] = -1e9
    before = fa.LAUNCHES["focal_attention"]
    got = fa.focal_attention(q, ko, vo, kg, vg, bias_o, bias_g, b, heads)
    assert fa.LAUNCHES["focal_attention"] == before + 1
    want = fa.focal_attention_plain(q.float(), ko.float(), vo.float(),
                                    kg.float(), vg.float(), bias_o, bias_g,
                                    b, heads)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        # 3xTF32 keeps float32 accuracy; one TF32 pass would be ~1e-4 off
        assert (got - want).abs().max() <= 1e-5
    else:
        assert (got.float() - want).abs().max() / want.abs().max() < 5e-2


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
    _assert_close_to_plain(got, want, dtype, (1e-5, 1e-4), 2e-2)
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
    _, bias_rows, s = tfocal._window_tables(fh, fw, 5, 9, 2, 4, 4, 8,
                                            torch.device("cuda"))
    nwin, nq = (fh // 5) * (fw // 9), t * 45
    assert (fh, fw, nwin, s) == (20, 72, 32, 141)
    fv = torch.ones((b, t), dtype=torch.bool, device="cuda")
    fv[0, 2] = False                    # an end-padded window
    bias_g = bias_rows[None, :, None, :].expand(b, nwin, t, s)
    bias_g = torch.where(fv[:, None, :, None], bias_g, -1e9)
    bias_g = bias_g.reshape(b * nwin, 1, t * s).contiguous()
    bias_o = torch.where(fv, 0.0, -1e9)[:, :, None].expand(b, t, 45)
    bias_o = bias_o.reshape(b, 1, nq).contiguous()
    q = _randn(gen, b * heads * nwin, nq, hd, std=hd ** -0.5).to(dtype)
    ko, vo = (_randn(gen, b * heads * nwin, nq, hd).to(dtype)
              for _ in range(2))
    kg, vg = (_randn(gen, b * heads, t, nwin, s, hd).to(dtype)
              for _ in range(2))
    got = fa.focal_attention(q, ko, vo, kg, vg, bias_o, bias_g, b, heads)
    want = fa.focal_attention_plain(q.float(), ko.float(), vo.float(),
                                    kg.float(), vg.float(), bias_o, bias_g,
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
    x = _randn(gen, 1, 4, 5, 8).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        deform.flow_warp(x, torch.zeros((1, 4, 5, 2), device="cuda"))
    assert np.isfinite(deform.flow_warp(
        x.detach(), torch.zeros((1, 4, 5, 2), device="cuda")).cpu()).all()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cbatch", [False, True])
def test_band_sample_matches_plain(gen, dtype, cbatch):
    inputs = _band_inputs(gen, dtype)
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


def test_packed_band_samplers_bit_equal_base(gen):
    src, *rest = _band_inputs(gen, torch.bfloat16)
    base = bs.band_sample(src, *rest)
    assert torch.equal(bs.band_sample(src.float(), *rest,
                                      out_dtype=torch.bfloat16), base)
    assert torch.equal(bs.band_sample_xpair(bs.pack_xpairs(src), *rest),
                       base)
    assert torch.equal(bs.band_sample_cpair(bs.pack_cpairs(src), *rest),
                       base)
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


@pytest.mark.parametrize("frame_valid", [False, True])
def test_band_attention_matches_plain_and_k3(gen, frame_valid):
    from e2fgvi_tpu_torch.models import tfocal
    block, x, pooled = _attn_block(gen)
    fv = None
    if frame_valid:
        fv = torch.ones((2, 3), dtype=torch.bool, device="cuda")
        fv[0, -1] = False
        fv[1, -2:] = False
    args = (block.attn, x, pooled, 2, (5, 9), (2, 4))
    before = ba.LAUNCHES["band_attention"]
    got = ba.band_attention(*args, frame_valid=fv).float()
    assert ba.LAUNCHES["band_attention"] == before + 1
    want = ba.band_attention_plain(block.attn, x.float(), pooled.float(),
                                   *args[3:], frame_valid=fv).float()
    k3 = tfocal.window_attention(*args, frame_valid=fv).float()
    if fv is not None:
        valid = fv.repeat_interleave(45, 1).repeat_interleave(4, 0)[..., None]
        got, want, k3 = (torch.where(valid, z, 0.0) for z in (got, want, k3))
    scale = want.abs().max()
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
