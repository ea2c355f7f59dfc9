"""E1/E5/E6: the banded sampler's plain forms and packers against the JAX
package's sampler (dcn_band._build_sampler, light form, interpret mode) on
the CPU. float32 to atol 1e-5; bfloat16 within one bfloat16 ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.kernels import dcn_band
from e2fgvi_tpu_torch.kernels import band_sampler as bs

torch.set_num_threads(2)
NG, K, CG, HP, WP = 4, 3, 4, 8, 16


def _inputs(band, seed=0):
    """Positions that leave the band (|dy| up to band) and the image."""
    rng = np.random.default_rng(seed)
    dy_lo = -(band // 2)
    src = rng.standard_normal((NG, CG, HP + band, WP)).astype(np.float32)
    rows = np.arange(HP, dtype=np.float32)[None, None, :, None]
    py = (rows + rng.uniform(-band, band, (NG, K, HP, WP))).astype(np.float32)
    py[0, 0, 0, :4] = [-1e4, 1e4, dy_lo - 0.5, 3.0]        # far out, exact
    px = rng.uniform(-3, WP + 3, (NG, K, HP, WP)).astype(np.float32)
    mask = rng.uniform(0, 1, (NG, K, HP, WP)).astype(np.float32)
    return src, py, px, mask, dy_lo


def _jax_sampler(band, dtype, packed=False):
    return dcn_band._build_sampler(NG, K, CG, HP, WP, band, -(band // 2),
                                   dtype, True, light=True, packed=packed)


def _bf16_ulps(got, want):
    """Distance in bfloat16 ulps (both bfloat16-valued float32 arrays);
    -0 and +0 are one value."""
    def ordered(a):
        b = torch.from_numpy(np.array(a)).bfloat16().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)
    return int((ordered(got) - ordered(want)).abs().max())


@pytest.mark.parametrize("band", [8, 16])
def test_band_sample_plain_f32_matches_jax(band):
    src, py, px, mask, dy_lo = _inputs(band)
    want = np.asarray(_jax_sampler(band, "float32")(
        *map(jnp.asarray, (src, py, px, mask))))
    got = bs.band_sample(*map(torch.from_numpy, (src, py, px, mask)), dy_lo)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.5


@pytest.mark.parametrize("band", [8, 16])
def test_band_sample_plain_bf16_matches_jax(band):
    src, py, px, mask, dy_lo = _inputs(band, seed=1)
    src16 = jnp.asarray(src, jnp.bfloat16)
    want = np.asarray(_jax_sampler(band, "bfloat16")(
        src16, *map(jnp.asarray, (py, px, mask))).astype(jnp.float32))
    t16 = torch.from_numpy(src).bfloat16()
    got = bs.band_sample(t16, *map(torch.from_numpy, (py, px, mask)), dy_lo)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), want) <= 1
    # float32 gathers with a bfloat16 output (E5 `base`) give the same bits
    got32 = bs.band_sample(t16.float(), *map(torch.from_numpy,
                                             (py, px, mask)), dy_lo,
                           out_dtype=torch.bfloat16)
    assert torch.equal(got32, got)


def test_pack_xpairs_equals_jax_pack_pairs():
    src, *_ = _inputs(8)
    src16 = torch.from_numpy(src).bfloat16()
    want = np.asarray(dcn_band._pack_pairs(jnp.asarray(src, jnp.bfloat16)))
    got = bs.pack_xpairs(src16)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(bs.unpack_xpairs(got), src16)


def test_xpair_plain_matches_jax_packed_sampler():
    band = 8
    src, py, px, mask, dy_lo = _inputs(band, seed=2)
    psrc = dcn_band._pack_pairs(jnp.asarray(src, jnp.bfloat16))
    want = np.asarray(_jax_sampler(band, "bfloat16", packed=True)(
        psrc, *map(jnp.asarray, (py, px, mask))).astype(jnp.float32))
    got = bs.band_sample_xpair(torch.from_numpy(np.array(psrc)),
                               *map(torch.from_numpy, (py, px, mask)), dy_lo)
    assert _bf16_ulps(got.float().numpy(), want) <= 1


def test_pack_cpairs_round_trips_and_orders_halves():
    src, py, px, mask, dy_lo = _inputs(8, seed=3)
    src16 = torch.from_numpy(src).bfloat16()
    psrc = bs.pack_cpairs(src16)
    assert psrc.shape == (NG, CG // 2, HP + 8, WP)
    assert torch.equal(bs.unpack_cpairs(psrc), src16)
    bits = src16.view(torch.int16).int() & 0xFFFF
    low = psrc & 0xFFFF
    assert torch.equal(low, bits[:, 0::2])                  # channel 2c
    got = bs.band_sample_cpair(psrc, *map(torch.from_numpy, (py, px, mask)),
                               dy_lo)
    want = bs.band_sample(src16, *map(torch.from_numpy, (py, px, mask)),
                          dy_lo)
    assert torch.equal(got, want)


def test_cbatch_plain_rounds_once():
    """(acc * mask) cast once: the JAX float32 sampler with mask 1, times
    the mask, cast to bfloat16."""
    band = 16
    src, py, px, mask, dy_lo = _inputs(band, seed=4)
    src16 = torch.from_numpy(src).bfloat16()
    acc = np.asarray(_jax_sampler(band, "float32")(
        jnp.asarray(src16.float().numpy()), jnp.asarray(py), jnp.asarray(px),
        jnp.ones_like(jnp.asarray(mask))))
    want = (jnp.asarray(acc) * jnp.asarray(mask)[:, :, None]).astype(
        jnp.bfloat16).astype(jnp.float32)
    got = bs.band_sample_cbatch(src16, *map(torch.from_numpy,
                                            (py, px, mask)), dy_lo)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), np.asarray(want)) <= 1
    got32 = bs.band_sample_cbatch(torch.from_numpy(src),
                                  *map(torch.from_numpy, (py, px, mask)),
                                  dy_lo)
    want32 = bs.band_sample(torch.from_numpy(src),
                            *map(torch.from_numpy, (py, px, mask)), dy_lo)
    assert torch.equal(got32, want32)


def test_pack_refuses_wrong_dtypes():
    with pytest.raises(ValueError, match="bfloat16"):
        bs.pack_xpairs(torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="even channel"):
        bs.pack_cpairs(torch.zeros((1, 3, 2, 4), dtype=torch.bfloat16))
