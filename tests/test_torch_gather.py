"""E3 and E4: the plain forms of row_gather and bilinear4_sample against
the JAX formulations of scripts/exp_gather.py, written here in jnp (the
script itself is not imported): E3 exact against take_along_axis, E4 to
1e-6 against the script's np_sample formula (:221-235)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu_torch.kernels import gather

torch.set_num_threads(2)
H, W, C, G, T = 6, 10, 32, 8, 3
P = H * W


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_row_gather_plain_matches_take_along_axis(dtype):
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((P, C)).astype(np.float32)
    idx = rng.integers(0, P, (T, P, C)).astype(np.int32)
    jtab = jnp.asarray(tab, jnp.bfloat16 if dtype == "bfloat16" else None)
    want = jnp.take_along_axis(jtab, jnp.asarray(idx).reshape(T * P, C),
                               axis=0).reshape(T, P, C)
    ttab = torch.from_numpy(tab)
    if dtype == "bfloat16":
        ttab = ttab.bfloat16()
    got = gather.row_gather(ttab, torch.from_numpy(idx))
    assert got.dtype == ttab.dtype and got.shape == (T, P, C)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _jnp_sample(tab, py, px):
    """The np_sample formula of scripts/exp_gather.py, in jnp float32."""
    pyl = jnp.tile(py, (1, 1, C // G))
    pxl = jnp.tile(px, (1, 1, C // G))
    y0 = jnp.clip(jnp.floor(pyl), 0, H - 2).astype(jnp.int32)
    x0 = jnp.clip(jnp.floor(pxl), 0, W - 2).astype(jnp.int32)
    wy0 = jnp.maximum(1 - jnp.abs(pyl - y0), 0)
    wy1 = jnp.maximum(1 - jnp.abs(pyl - y0 - 1), 0)
    wx0 = jnp.maximum(1 - jnp.abs(pxl - x0), 0)
    wx1 = jnp.maximum(1 - jnp.abs(pxl - x0 - 1), 0)
    lanes = jnp.arange(C)[None, None, :]
    return (tab[y0 * W + x0, lanes] * wy0 * wx0
            + tab[y0 * W + x0 + 1, lanes] * wy0 * wx1
            + tab[(y0 + 1) * W + x0, lanes] * wy1 * wx0
            + tab[(y0 + 1) * W + x0 + 1, lanes] * wy1 * wx1)


def test_bilinear4_plain_matches_jnp_formula():
    rng = np.random.default_rng(1)
    tab = rng.standard_normal((P, C)).astype(np.float32)
    # positions inside the map and past its edges (clamped corners)
    py = rng.uniform(-2, H + 1, (T, P, G)).astype(np.float32)
    px = rng.uniform(-2, W + 1, (T, P, G)).astype(np.float32)
    want = np.asarray(_jnp_sample(*map(jnp.asarray, (tab, py, px))))
    got = gather.bilinear4_sample(*map(torch.from_numpy, (tab, py, px)), H,
                                  W)
    assert got.shape == (T, P, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_bilinear4_lane_takes_group_j_mod_g():
    """Lane j reads group j % G: a table that is constant per lane and a
    position that differs per group show the map."""
    tab = torch.arange(C, dtype=torch.float32)[None, :].repeat(P, 1)
    py = torch.zeros((1, 1, G))
    px = torch.zeros((1, 1, G))
    px[0, 0, 3] = 0.25                     # group 3: weight 0.25 on x0+1
    got = gather.bilinear4_sample(tab, py, px, H, W)[0, 0]
    lanes = torch.arange(C, dtype=torch.float32)
    torch.testing.assert_close(got, lanes)   # every row holds the same
    tab2 = tab.clone()
    tab2[1] += 100.0                       # the (0, 1) corner differs
    got2 = gather.bilinear4_sample(tab2, py, px, H, W)[0, 0]
    torch.testing.assert_close(got2 - got,
                               torch.where(lanes % G == 3, 25.0, 0.0))
