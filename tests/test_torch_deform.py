"""Plain versions of K1 (head-fused DCNv2) and K2 (flow warp) in
e2fgvi_tpu_torch/kernels/deform.py against the JAX package: the banded
Pallas sampler in interpret mode and the XLA formulations, float32,
rtol 1e-5 / atol 1e-4. On CPU tensors the wrappers take these plain
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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    np.testing.assert_allclose(got, np.asarray(want_b), **TOL)
    flow[..., 1] *= 3.0           # the XLA warp takes any offset
    got = deform.flow_warp(_t(x), _t(flow)).numpy()
    want = jwarp(jnp.asarray(x), jnp.asarray(flow))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(rng):
    """Forward-only: a CUDA input with grad history raises before launch;
    a CPU input takes the plain version."""
    x = torch.zeros((1, 4, 5, 8))
    assert deform.flow_warp(x, torch.zeros((1, 4, 5, 2))).shape == x.shape
    with pytest.raises(ValueError):
        deform.check_cuda_inputs("k", x)


# ---------------------------------------------------------------------------
# The bf16 K1 (csrc/deform.cu, namespace fused): its tile schedule emulated
# in float32, and the wrapper's contract
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


def test_fused_weight_is_the_im2col_column_order(rng):
    """fused_weight(w)[o, (g*K + k)*16 + c] == w[o, g*16 + c, ky, kx]: the
    column order of deform_columns_plain and the f32 im2col kernel."""
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


# (Cin, head groups, Cout, kernel): each breaks one term of the contract
_BAD_FUSED = {"cg8": (64, 8, 128, 3, "CG == 16"),
              "cout16": (64, 4, 16, 3, "Cout == 128"),
              "partial_chunk": (32, 2, 128, 3, "multiple of 4")}


@pytest.mark.parametrize("case", list(_BAD_FUSED))
def test_fused_shape_checks_name_the_contract(case):
    cin, g, cout, kk, words = _BAD_FUSED[case]
    x = torch.zeros((1, 4, 5, cin))
    head = torch.zeros((1, 4, 5, 3 * kk * kk * g))
    with pytest.raises(ValueError, match=words):
        deform.check_fused_shapes(x, head, torch.zeros((cout, cin, kk, kk)))
    deform.check_fused_shapes(torch.zeros((1, 4, 5, 256)),
                              torch.zeros((1, 4, 5, 432)),
                              torch.zeros((128, 256, 3, 3)))


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
    """conv_operands, made once per pass by feat_prop: in float32 the GEMM's
    (G*K*CG, Cout) with column order (g*K + k)*CG + c at any CG, element
    for element the reorder the wrapper made per call before; in bfloat16
    the fused kernel's (Cout, K) weight and the bias rounded to bf16 in
    float32 (zeros without one)."""
    w = torch.from_numpy(rng.standard_normal((128, 64, 3, 3))
                         .astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    if dtype == torch.float32:
        wk, bk = deform.conv_operands(w, b, dtype, groups)
        cg = 64 // groups
        want = w.reshape(128, groups, cg, 9).permute(1, 3, 2, 0)
        assert wk.is_contiguous()
        assert torch.equal(wk, want.reshape(groups * 9 * cg, 128))
        assert torch.equal(bk, b)
        assert deform.conv_operands(w, None, dtype, groups).bias is None
    else:
        wk, bk = deform.conv_operands(w, b, dtype)
        assert wk.dtype == torch.bfloat16
        assert torch.equal(wk, deform.fused_weight(w))
        assert bk.dtype == torch.float32
        assert torch.equal(bk, b.bfloat16().float())
        assert torch.equal(deform.conv_operands(w, None, dtype).bias,
                           torch.zeros(128))


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
