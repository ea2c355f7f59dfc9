"""The port's ops (e2fgvi_tpu_torch/ops) against e2fgvi_tpu.ops on the same
numpy inputs, float32, tolerance 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.ops import convs as jconvs
from e2fgvi_tpu.ops import patches as jpatches
from e2fgvi_tpu.ops import resize as jresize
from e2fgvi_tpu.ops import warp as jwarp
from e2fgvi_tpu_torch.ops import convs, patches, resize, warp

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got_t, want_j, **tol):
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j),
                               **(tol or TOL))


@pytest.fixture
def x(rng):
    return rng.standard_normal((2, 13, 19, 5)).astype(np.float32)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("size", [(7, 11), (27, 40), (13, 19), (1, 5)])
def test_resize_bilinear(x, align, size):
    xj, xt = _both(x)
    _close(resize.resize_bilinear(xt, *size, align),
           jresize.resize_bilinear(xj, *size, align_corners=align))


def test_resize_quarter_scale2_avgpool(rng):
    a = rng.standard_normal((3, 242, 434, 3)).astype(np.float32)
    aj, at = _both(a)
    _close(resize.resize_scale_quarter(at), jresize.resize_scale_quarter(aj))
    s = a[:, :31, :45]
    sj, st = _both(np.ascontiguousarray(s))
    _close(resize.resize_scale2_aligned(st), jresize.resize_scale2_aligned(sj))
    _close(resize.avg_pool_2x2(st), jresize.avg_pool_2x2(sj))


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample(x, rng, mode):
    grid = rng.uniform(-1.4, 1.4, (2, 9, 7, 2)).astype(np.float32)
    xj, xt = _both(x)
    gj, gt = _both(grid)
    _close(warp.grid_sample_bilinear(xt, gt, mode),
           jwarp.grid_sample_bilinear(xj, gj, mode))


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_flow_warp(x, rng, mode):
    flow = (rng.standard_normal((2, 13, 19, 2)) * 6).astype(np.float32)
    xj, xt = _both(x)
    fj, ft = _both(flow)
    _close(warp.flow_warp(xt, ft, mode), jwarp.flow_warp(xj, fj, mode))


def _patches_to_torch(p):
    """JAX (N, Lh, Lw, kh, kw, C) -> torch (N, C*kh*kw, Lh*Lw)."""
    n, lh, lw, kh, kw, c = p.shape
    return p.transpose(0, 5, 3, 4, 1, 2).reshape(n, c * kh * kw, lh * lw)


@pytest.mark.parametrize("geom", [((7, 7), (3, 3), (3, 3)),
                                  ((3, 5), (2, 1), (1, 2))])
def test_unfold_fold(rng, geom):
    k, s, p = geom
    img = rng.standard_normal((2, 17, 22, 4)).astype(np.float32)
    want = np.asarray(jpatches.unfold(jnp.asarray(img), k, s, p))
    got = patches.unfold(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                         k, s, p)
    np.testing.assert_allclose(got.numpy(), _patches_to_torch(want), **TOL)

    pj = rng.standard_normal(want.shape).astype(np.float32)
    pt = torch.from_numpy(_patches_to_torch(pj).copy())
    for jf, tf in ((jpatches.fold, patches.fold),
                   (jpatches.fold_normalized, patches.fold_normalized)):
        wj = np.asarray(jf(jnp.asarray(pj), (17, 22), k, s, p))
        got = tf(pt, (17, 22), k, s, p).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), wj, **TOL)


@pytest.mark.parametrize("groups,stride", [(1, 1), (2, 2), (4, 1)])
def test_conv2d(rng, groups, stride):
    a = rng.standard_normal((2, 11, 14, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8 // groups, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = jconvs.conv2d(jnp.asarray(a), jnp.asarray(w), jnp.asarray(b),
                         stride=stride, padding=1, groups=groups)
    got = convs.conv2d(torch.from_numpy(a),
                       torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(b), stride=stride, padding=1,
                       groups=groups)
    _close(got, want, rtol=1e-5, atol=1e-4)


def test_norm_linear_activations(rng):
    a = (rng.standard_normal((3, 7, 16)) * 3).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    bb = rng.standard_normal(16).astype(np.float32)
    w = rng.standard_normal((16, 9)).astype(np.float32)
    aj, at = _both(a)
    _close(convs.layer_norm(at, torch.from_numpy(g), torch.from_numpy(bb)),
           jconvs.layer_norm(aj, jnp.asarray(g), jnp.asarray(bb)),
           rtol=1e-5, atol=1e-5)
    _close(convs.linear(at, torch.from_numpy(w.T.copy()),
                        torch.from_numpy(bb[:9].copy())),
           jconvs.linear(aj, jnp.asarray(w), jnp.asarray(bb[:9])),
           rtol=1e-5, atol=1e-4)
    _close(convs.gelu(at), jconvs.gelu(aj))
    _close(convs.leaky_relu(at, 0.1), jconvs.leaky_relu(aj, 0.1))
