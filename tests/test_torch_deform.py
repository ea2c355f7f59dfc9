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
