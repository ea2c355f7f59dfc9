"""Plain versions of K1 (head-fused DCNv2) and K2 (flow warp) in
e2fgvi_tpu_torch/kernels/deform.py against the JAX package: the banded
Pallas sampler in interpret mode and the XLA formulations, float32. Both
plain versions sample at pixel positions, as the JAX K1 and K2 do, so they
are held to PLAIN_TOL (rtol 1e-6, atol 5e-6: float32 sums in another
order; they read ~2e-6 at most); the emulated kernel schedules to TOL
(rtol 1e-5, atol 1e-4). On CPU tensors the wrappers take these plain
versions, so the wrappers are what is called here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.kernels.dcn_band import (flow_warp_banded,
                                         modulated_deform_conv2d_banded_head)
from e2fgvi_tpu.models import feat_prop as jfp
from e2fgvi_tpu.ops.dcn import modulated_deform_conv2d as jdcn
from e2fgvi_tpu.ops.warp import flow_warp as jwarp
from e2fgvi_tpu_torch.kernels import deform

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-4)
PLAIN_TOL = dict(rtol=1e-6, atol=5e-6)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oihw(w_hwio):
    return _t(w_hwio.transpose(3, 2, 0, 1))


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    import jax
    jax.clear_caches()


def test_k1_plain_matches_banded_head_interpret(rng):
    """The shapes of tests/test_dcn_band.py's head-fused test; a wide band
    so the banded kernel is exact for every sample."""
    n, h, w, g, k, cin, cout = 1, 12, 16, 4, 9, 8, 4
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    head = (rng.standard_normal((n, h, w, 3 * k * g)) * 0.3).astype(np.float32)
    f1 = (rng.standard_normal((n, h, w, 2)) * 2).astype(np.float32)
    f2 = (rng.standard_normal((n, h, w, 2)) * 2).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want, _ = modulated_deform_conv2d_banded_head(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(f1), jnp.asarray(f2),
        jnp.asarray(wgt), jnp.asarray(b), band=64, max_residue=10.0,
        interpret=True)
    got = deform.modulated_deform_conv2d_head(_t(x), _t(head), _t(f1),
                                              _t(f2), _oihw(wgt), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAIN_TOL)


def test_k1_plain_large_offsets_matches_xla(rng):
    """|off_y| up to 30: the port has no band, so any offset is exact."""
    n, h, w, g, k, cin, cout = 2, 14, 18, 4, 9, 16, 6
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    off = rng.uniform(-30, 30, (n, h, w, g, k, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, g, k)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = jdcn(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
                jnp.asarray(wgt), jnp.asarray(b))
    got = deform.modulated_deform_conv2d(_t(x), _t(off), _t(mask),
                                         _oihw(wgt), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAIN_TOL)


def test_k1_head_split_matches_jax(rng, monkeypatch):
    """offsets_from_head (the (dx, dy) -> (dy, dx) swap, the G/2 flow
    split, tanh and sigmoid) against the JAX _offsets_from_head, with flows
    large enough to send samples outside the image, then the whole plain
    K1 against JAX's split form + XLA DCN."""
    n, h, w, g, k, cin, cout = 1, 10, 13, 4, 9, 8, 5
    monkeypatch.setattr(jfp, "DEFORM_GROUPS", g)
    head = rng.standard_normal((n, h, w, 3 * k * g)).astype(np.float32)
    f1 = (rng.standard_normal((n, h, w, 2)) * 12).astype(np.float32)
    f2 = (rng.standard_normal((n, h, w, 2)) * 12).astype(np.float32)
    want_off, want_mask = jfp._offsets_from_head(
        jnp.asarray(head), jnp.asarray(f1), jnp.asarray(f2))
    off, mask = deform.offsets_from_head(_t(head), _t(f1), _t(f2))
    np.testing.assert_allclose(off.numpy(), np.asarray(want_off), **TOL)
    np.testing.assert_allclose(mask.numpy(), np.asarray(want_mask), **TOL)

    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    want = jdcn(jnp.asarray(x), want_off, want_mask, jnp.asarray(wgt))
    got = deform.modulated_deform_conv2d_head(_t(x), _t(head), _t(f1),
                                              _t(f2), _oihw(wgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAIN_TOL)


@pytest.mark.parametrize("c", [2, 128])
def test_k2_plain_matches_banded_and_xla(rng, c):
    n, h, w = 2, 10, 14
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-1, 1, (n, h, w, 2)).astype(np.float32)
    flow[..., 0] *= 25.0          # samples well outside the image in x
    flow[..., 1] *= 8.0           # and in y, inside the banded contract
    got = deform.flow_warp(_t(x), _t(flow)).numpy()
    want_b = flow_warp_banded(jnp.asarray(x), jnp.asarray(flow), band=32,
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_b), **PLAIN_TOL)
    flow[..., 1] *= 3.0           # the XLA warp takes any offset; it
    got = deform.flow_warp(_t(x), _t(flow)).numpy()   # normalizes its grid
    want = jwarp(jnp.asarray(x), jnp.asarray(flow))   # in float32 (~1e-6 px)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _normalized_grid_warp(x, flow):
    """The plain K2 before it sampled at pixel positions: F.grid_sample on
    the grid normalized in float32 (align_corners=True)."""
    _, h, w, _ = x.shape
    gy = torch.arange(h, dtype=torch.float32)[:, None] + flow[..., 1]
    gx = torch.arange(w, dtype=torch.float32)[None, :] + flow[..., 0]
    grid = torch.stack([2 * gx / (w - 1) - 1, 2 * gy / (h - 1) - 1], -1)
    return torch.nn.functional.grid_sample(
        x.permute(0, 3, 1, 2), grid, align_corners=True).permute(0, 2, 3, 1)


def test_k1_k2_plain_sample_at_pixel_positions_on_wide_maps(rng):
    """Maps 324 columns wide (the HQ model's at 1296x720), where a float32
    normalized grid moves a sample by ~1e-5 px. K2 against the JAX
    package's pixel-position sampler (ops/dcn.bilinear_block_sample, the
    banded K2's arithmetic; the banded kernel itself takes ~90 s in
    interpret mode at this width) on pixel noise: within PLAIN_TOL, where
    the normalized grid reads ~6e-5 off. K1 against the XLA DCN (which
    samples at pixel positions) with offsets far outside the image."""
    from e2fgvi_tpu.ops.dcn import bilinear_block_sample
    n, h, w, c = 1, 6, 324, 8
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-1, 1, (n, h, w, 2)).astype(np.float32)
    flow[..., 0] *= 25.0
    flow[..., 1] *= 8.0
    py = (np.arange(h, dtype=np.float32)[:, None] + flow[..., 1]).reshape(n, -1)
    px = (np.arange(w, dtype=np.float32)[None, :] + flow[..., 0]).reshape(n, -1)
    want = np.asarray(bilinear_block_sample(
        jnp.asarray(x), jnp.asarray(py), jnp.asarray(px))).reshape(x.shape)
    got = deform.flow_warp(_t(x), _t(flow)).numpy()
    np.testing.assert_allclose(got, want, **PLAIN_TOL)
    old = _normalized_grid_warp(_t(x), _t(flow)).numpy()
    assert np.abs(old - want).max() > 1e-5     # the case tells them apart

    g, cin = 4, 64
    x = rng.standard_normal((n, 4, w, cin)).astype(np.float32)
    head = rng.standard_normal((n, 4, w, 27 * g)).astype(np.float32)
    f1 = (rng.standard_normal((n, 4, w, 2)) * 3).astype(np.float32)
    f2 = (rng.standard_normal((n, 4, w, 2)) * 3).astype(np.float32)
    f2[..., 0] += 200.0
    wgt = (rng.standard_normal((3, 3, cin, 128)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    off, mask = deform.offsets_from_head(_t(head), _t(f1), _t(f2))
    want = jdcn(jnp.asarray(x), jnp.asarray(off.numpy()),
                jnp.asarray(mask.numpy()), jnp.asarray(wgt), jnp.asarray(b))
    got = deform.modulated_deform_conv2d_head(_t(x), _t(head), _t(f1),
                                              _t(f2), _oihw(wgt), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAIN_TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(rng):
    """Forward-only: a CUDA input with grad history raises before launch;
    a CPU input takes the plain version."""
    x = torch.zeros((1, 4, 5, 8))
    assert deform.flow_warp(x, torch.zeros((1, 4, 5, 2))).shape == x.shape
    with pytest.raises(ValueError):
        deform.check_cuda_inputs("k", x)


# ---------------------------------------------------------------------------
# The bf16 K1 (csrc/deform.cu, namespace fused): its tile schedule emulated
# in float32
# ---------------------------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float()


def _emulate_fused_kernel(x, head, f1, f2, weight, bias, bm=128, bk=64):
    """The bf16 K1's schedule in float32: BM-row pixel tiles, the last one
    ragged (its rows past M sampled as zeros and not stored); 64-wide K
    chunks of 4 (g, tap) slices in the kernel's column order
    (g*K + k)*CG + c, summed chunk by chunk; A (the masked samples)
    rounded once to bf16; the wrapper's own (Cout, K) bf16 weight; the f32
    bias in the epilogue, then one rounding to bf16."""
    a = deform.deform_columns_plain(x, head, f1, f2).bfloat16().float()
    wk, b32 = deform.conv_operands(weight, bias, torch.bfloat16)
    wk = wk.float()
    m, ktot = a.shape
    assert ktot % bk == 0 and wk.shape == (deform.FUSED_COUT, ktot)
    out = torch.empty((m, wk.shape[0]))
    for t0 in range(0, m, bm):
        rows = min(bm, m - t0)
        tile = torch.zeros((bm, ktot))
        tile[:rows] = a[t0:t0 + rows]
        acc = torch.zeros((bm, wk.shape[0]))
        for k0 in range(0, ktot, bk):
            acc += tile[:, k0:k0 + bk] @ wk[:, k0:k0 + bk].T
        out[t0:t0 + rows] = (acc + b32)[:rows].bfloat16().float()
    return out.reshape(*x.shape[:3], wk.shape[0])


def _fused_inputs(rng, n, h, w, g):
    """bf16-valued float32 inputs at the fused kernel's widths (CG 16,
    Cout 128), flows that push samples outside the image."""
    cin = 16 * g
    x = _bf16(rng.standard_normal((n, h, w, cin)))
    head = _bf16(rng.standard_normal((n, h, w, 27 * g)) * 0.5)
    f1 = torch.from_numpy((rng.standard_normal((n, h, w, 2)) * 3)
                          .astype(np.float32))
    f2 = torch.from_numpy((rng.standard_normal((n, h, w, 2)) * 3)
                          .astype(np.float32))
    f2[:, :, -3:, 0] += 25.0
    wgt = _bf16(rng.standard_normal((3, 3, cin, 128)) * 0.05)   # HWIO
    b = _bf16(rng.standard_normal(128) * 0.1)
    return x, head, f1, f2, wgt, b


def test_k1_fused_schedule_matches_plain(rng):
    """N=2 of 13x21: M = 546 pixels, 4 whole tiles and a ragged one of 34
    rows; G=4: 9 K chunks. Against the plain version on the same bf16
    values: A's rounding (2^-9 of each sample) and the output's leave
    ~3e-3 of the output's scale; a column or tile off by one is O(1)."""
    x, head, f1, f2, wgt, b = _fused_inputs(rng, 2, 13, 21, 4)
    w = wgt.permute(3, 2, 0, 1).contiguous()
    got = _emulate_fused_kernel(x, head, f1, f2, w, b)
    want = deform.deform_conv_head_plain(x, head, f1, f2, w, b)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() / want.abs().max() <= 1e-2


def test_k1_fused_schedule_matches_banded_head_interpret(rng):
    """The emulated schedule against the JAX head-fused DCN (the banded
    Pallas sampler in interpret mode, a band wide enough to be exact) on
    N=1 of 13x21: M = 273, two tiles and a ragged one of 17 rows."""
    x, head, f1, f2, wgt, b = _fused_inputs(rng, 1, 13, 21, 4)
    want, _ = modulated_deform_conv2d_banded_head(
        *(jnp.asarray(t.numpy()) for t in (x, head, f1, f2, wgt, b)),
        band=64, max_residue=10.0, interpret=True)
    got = _emulate_fused_kernel(x, head, f1, f2,
                                wgt.permute(3, 2, 0, 1).contiguous(), b)
    want = torch.from_numpy(np.array(want))
    assert (got - want).abs().max() / want.abs().max() <= 1e-2


# ---------------------------------------------------------------------------
# The float32 K1 (csrc/deform.cu, namespace fused_tf32): its 3xTF32 tile
# schedule emulated in torch
# ---------------------------------------------------------------------------

def _emulate_tf32_kernel(x, head, f1, f2, weight, bias, passes=3, bm=128,
                         bk=32):
    """The float32 K1's schedule: BM-row pixel tiles, the last one ragged
    (its rows past M sampled as zeros and not stored); 32-wide K chunks of
    2 (g, tap) slices in the column order (g*K + k)*CG + c; A (the masked
    samples) split into tf32 big and small by bit operations
    (split_tf32), B the wrapper's own split weight; per chunk big*big into
    one accumulator, small*big + big*small into another; the f32 bias in
    the epilogue. passes=1: big*big alone, one TF32 pass."""
    a = deform.deform_columns_plain(x, head, f1, f2)
    a_big, a_small = deform.split_tf32(a)
    (w_big, w_small), b32 = deform.conv_operands(weight, bias, torch.float32)
    m, ktot = a.shape
    cout = w_big.shape[0]
    assert ktot % bk == 0 and w_big.shape == (deform.FUSED_COUT, ktot)
    out = torch.empty((m, cout))
    for t0 in range(0, m, bm):
        rows = min(bm, m - t0)
        tb, ts = torch.zeros((bm, ktot)), torch.zeros((bm, ktot))
        tb[:rows], ts[:rows] = a_big[t0:t0 + rows], a_small[t0:t0 + rows]
        hi, lo = torch.zeros((bm, cout)), torch.zeros((bm, cout))
        for k0 in range(0, ktot, bk):
            ks = slice(k0, k0 + bk)
            hi += tb[:, ks] @ w_big[:, ks].T
            if passes == 3:
                lo += ts[:, ks] @ w_big[:, ks].T + tb[:, ks] @ w_small[:, ks].T
        out[t0:t0 + rows] = (hi + lo + b32)[:rows]
    return out.reshape(*x.shape[:3], cout)


def _tf32_inputs(rng, n, h, w, g):
    """float32 inputs at the fused kernel's widths (CG 16, Cout 128), flows
    that push samples outside the image; the weight HWIO."""
    def draw(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std)
                                .astype(np.float32))
    cin = 16 * g
    x, head = draw(n, h, w, cin), draw(n, h, w, 27 * g, std=0.5)
    f1, f2 = draw(n, h, w, 2, std=3.0), draw(n, h, w, 2, std=3.0)
    f2[:, :, -3:, 0] += 25.0
    return x, head, f1, f2, draw(3, 3, cin, 128, std=0.05), draw(128, std=0.1)


@pytest.mark.parametrize("groups", [4, 2])
def test_k1_tf32_schedule_matches_plain(rng, groups):
    """N=2 of 13x21: M = 546 pixels, 4 whole tiles and a ragged one of 34
    rows; G=4: 18 K chunks, G=2: 9 (G*K = 18, whole 32-wide chunks but no
    64-wide ones). Against the plain version: 3xTF32 within 2e-5 (~1e-6
    here, float32 sums in another order over the same samples), one TF32
    pass well outside it (~2^-11 of each product)."""
    x, head, f1, f2, wgt, b = _tf32_inputs(rng, 2, 13, 21, groups)
    w = wgt.permute(3, 2, 0, 1).contiguous()
    want = deform.deform_conv_head_plain(x, head, f1, f2, w, b)
    got = _emulate_tf32_kernel(x, head, f1, f2, w, b)
    one = _emulate_tf32_kernel(x, head, f1, f2, w, b, passes=1)
    err, err1 = ((z - want).abs().max().item() for z in (got, one))
    assert torch.isfinite(got).all()
    assert err <= 2e-5 and err1 > 2e-5, (err, err1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k1_tf32_schedule_matches_banded_head_interpret(rng):
    """The emulated float32 schedule against the JAX head-fused DCN (the
    banded Pallas sampler in interpret mode, a band wide enough to be
    exact) on N=1 of 13x21: M = 273, two tiles and a ragged one of 17
    rows."""
    x, head, f1, f2, wgt, b = _tf32_inputs(rng, 1, 13, 21, 4)
    want, _ = modulated_deform_conv2d_banded_head(
        *(jnp.asarray(t.numpy()) for t in (x, head, f1, f2, wgt, b)),
        band=64, max_residue=10.0, interpret=True)
    got = _emulate_tf32_kernel(x, head, f1, f2,
                               wgt.permute(3, 2, 0, 1).contiguous(), b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_weight_is_the_im2col_column_order(rng):
    """fused_weight(w)[o, (g*K + k)*16 + c] == w[o, g*16 + c, ky, kx]: the
    column order of deform_columns_plain and of both kernels' A tiles."""
    w = torch.from_numpy(rng.standard_normal((128, 64, 3, 3))
                         .astype(np.float32))
    wk = deform.fused_weight(w)
    o, g, k, c = 5, 3, 7, 11
    assert wk.shape == (128, 64 * 9)
    assert wk[o, (g * 9 + k) * 16 + c] == w[o, g * 16 + c, k // 3, k % 3]
    x, head, f1, f2, wgt, _ = _fused_inputs(rng, 1, 5, 6, 4)
    w = wgt.permute(3, 2, 0, 1).contiguous()
    cols = deform.deform_columns_plain(x, head, f1, f2)
    torch.testing.assert_close(
        (cols @ deform.fused_weight(w).T).reshape(1, 5, 6, 128),
        deform.deform_conv_head_plain(x, head, f1, f2, w), rtol=1e-5,
        atol=1e-4)


# (Cin, head groups, Cout, kernel, dtype): each breaks one term of the
# contract; G*K = 18 is whole 32-wide float32 chunks but no whole 64-wide
# bfloat16 ones, G*K = 9 neither
_BAD_FUSED = {"cg8": (64, 8, 128, 3, torch.bfloat16, "CG == 16"),
              "cout16": (64, 4, 16, 3, torch.bfloat16, "Cout == 128"),
              "partial_chunk": (32, 2, 128, 3, torch.bfloat16,
                                "multiple of 4"),
              "cg8_f32": (64, 8, 128, 3, torch.float32, "CG == 16"),
              "cout16_f32": (64, 4, 16, 3, torch.float32, "Cout == 128"),
              "odd_gk_f32": (16, 1, 128, 3, torch.float32, "even")}


@pytest.mark.parametrize("case", list(_BAD_FUSED))
def test_fused_shape_checks_name_the_contract(case):
    cin, g, cout, kk, dtype, words = _BAD_FUSED[case]
    x = torch.zeros((1, 4, 5, cin), dtype=dtype)
    head = torch.zeros((1, 4, 5, 3 * kk * kk * g), dtype=dtype)
    with pytest.raises(ValueError, match=words):
        deform.check_fused_shapes(x, head, torch.zeros((cout, cin, kk, kk)))
    for dt in (torch.bfloat16, torch.float32):
        deform.check_fused_shapes(torch.zeros((1, 4, 5, 256), dtype=dt),
                                  torch.zeros((1, 4, 5, 432), dtype=dt),
                                  torch.zeros((128, 256, 3, 3)))
    deform.check_fused_shapes(torch.zeros((1, 4, 5, 32)),
                              torch.zeros((1, 4, 5, 54)),
                              torch.zeros((128, 32, 3, 3)))


def test_fused_shape_checks_f32_image_size():
    """The float32 K1 reads corners by 32-bit offsets: an image of x of
    2^31 elements raises (shapes only, on the meta device), one just under
    passes."""
    def shapes(h):
        return (torch.empty((1, h, 2 ** 11, 32), device="meta"),
                torch.empty((1, h, 2 ** 11, 54), device="meta"),
                torch.empty((128, 32, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="2\\^31"):
        deform.check_fused_shapes(*shapes(2 ** 15))
    deform.check_fused_shapes(*shapes(2 ** 15 - 1))


def test_k2_load_width_follows_alignment():
    """K2's wrapper takes 16 bytes of channels a thread and loads them as
    wide as x's address allows: a view 1 float in takes scalar loads, 2
    floats in 8-byte ones; the same rule for bf16."""
    base = torch.zeros(1024)
    assert deform.load_width(4, 4, base.data_ptr()) == 4
    assert deform.load_width(4, 4, base[1:].data_ptr()) == 1
    assert deform.load_width(4, 4, base[2:].data_ptr()) == 2
    assert deform.load_width(2, 4, base[2:].data_ptr()) == 2
    b16 = torch.zeros(1024, dtype=torch.bfloat16)
    assert deform.load_width(8, 2, b16.data_ptr()) == 8
    assert deform.load_width(8, 2, b16[4:].data_ptr()) == 4
    assert deform.load_width(8, 2, b16[1:].data_ptr()) == 1
    assert deform._channel_chunk(128, 4) == 4
    assert deform._channel_chunk(128, 8) == 8
    assert deform._channel_chunk(2, 4) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [4, 8])
def test_conv_operands_are_the_contraction_order(rng, dtype, groups):
    """conv_operands, made once per pass by feat_prop: the fused kernel's B
    operand K-major with column order (g*K + k)*CG + c at any CG (in
    bfloat16 the (Cout, K) weight, in float32 (2, Cout, K), its tf32 big
    and small parts), and the bias in float32 (rounded to bf16 first in
    bfloat16; zeros without one)."""
    w = torch.from_numpy(rng.standard_normal((128, 64, 3, 3))
                         .astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    wk, bk = deform.conv_operands(w, b, dtype, groups)
    cg = 64 // groups
    want = w.reshape(128, groups, cg, 9).permute(0, 1, 3, 2)
    want = want.reshape(128, groups * 9 * cg)
    assert wk.is_contiguous() and wk.dtype == dtype
    assert bk.dtype == torch.float32
    assert torch.equal(bk, b.to(dtype).float())
    assert torch.equal(deform.conv_operands(w, None, dtype, groups).bias,
                       torch.zeros(128))
    if dtype == torch.float32:
        assert wk.shape == (2, 128, groups * 9 * cg)
        big, small = deform.split_tf32(want)
        assert torch.equal(wk[0], big) and torch.equal(wk[1], small)
        err = (wk[0].double() + wk[1].double() - want.double()).abs()
        assert (err <= 2.0 ** -22 * want.double().abs()).all()
    else:
        assert torch.equal(wk, want)
        assert torch.equal(wk, deform.fused_weight(w, groups=groups))


def test_split_tf32_rounds_to_nearest_tf32(rng):
    """The float32 K1's operand split: big and small have their 13 low
    mantissa bits zero, big is the nearest tf32 (ties away from zero), and
    big + small is x to within 2^-22 |x|, over 60 octaves and both signs;
    zero splits into zeros."""
    x = (rng.standard_normal(4096) * 2.0 ** rng.integers(-30, 30, 4096))
    x = torch.from_numpy(np.concatenate([x, [0.0, 1.0, -1.0]])
                         .astype(np.float32))
    big, small = deform.split_tf32(x)
    for part in (big, small):
        assert part.dtype == torch.float32
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    ulp = 2.0 ** (torch.floor(torch.log2(x.double().abs().clamp_min(1e-38)))
                  - 10)
    assert ((x.double() - big.double()).abs() <= ulp / 2).all()
    err = (x.double() - big.double() - small.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert big[-3] == 0 and small[-3] == 0
    assert big[-2] == 1 and small[-2] == 0
    # 1 + 2^-11 is a tie between two tf32 values: away from zero
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert deform.split_tf32(tie)[0].tolist() == [1 + 2.0 ** -10,
                                                   -(1 + 2.0 ** -10)]


def test_aligned_copies_only_misaligned_views():
    """What the fused K1 and K2 do with a misaligned flow or fused-K1
    input: the tensor as it is where aligned, an aligned copy where not."""
    base = torch.arange(1024, dtype=torch.float32)
    assert deform._aligned(base, 16) is base
    view = base[1:]
    copy = deform._aligned(view, 8)
    assert copy is not view and copy.data_ptr() % 16 == 0
    assert torch.equal(copy, view)
    assert deform._aligned(base[4:], 16).data_ptr() == base[4:].data_ptr()


def test_feat_prop_makes_no_kernel_operands_on_the_cpu():
    from e2fgvi_tpu_torch.models.feat_prop import \
        SecondOrderDeformableAlignment
    align = SecondOrderDeformableAlignment(32, deform_groups=2)
    assert align.kernel_operands(torch.zeros((1, 4, 5, 64))) is None
