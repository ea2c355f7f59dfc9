"""E1/E5/E6: the banded sampler's plain forms and packers against the JAX
package's sampler (dcn_band._build_sampler, light form, interpret mode) on
the CPU. float32 to atol 1e-5; bfloat16 within one bfloat16 ulp. Then the
staged kernel's plan (band_sampler.plan): its shared memory, the rows it
stages, and the kernel's blocking emulated in torch, bit-equal to the plain
version on the whole source."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.kernels import dcn_band
from e2fgvi_tpu_torch.kernels import band_sampler as bs

torch.set_num_threads(2)
NG, K, CG, HP, WP = 4, 3, 4, 8, 16


def _inputs(band, seed=0, ng=NG, k=K, cg=CG, hp=HP, wp=WP):
    """Positions that leave the band (|dy| up to band) and the image."""
    rng = np.random.default_rng(seed)
    dy_lo = -(band // 2)
    src = rng.standard_normal((ng, cg, hp + band, wp)).astype(np.float32)
    rows = np.arange(hp, dtype=np.float32)[None, None, :, None]
    py = (rows + rng.uniform(-band, band, (ng, k, hp, wp))).astype(np.float32)
    py[0, 0, 0, :4] = [-1e4, 1e4, dy_lo - 0.5, 3.0]        # far out, exact
    px = rng.uniform(-3, wp + 3, (ng, k, hp, wp)).astype(np.float32)
    mask = rng.uniform(0, 1, (ng, k, hp, wp)).astype(np.float32)
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


# ---------------------------------------------------------------------------
# The staged kernel's plan
# ---------------------------------------------------------------------------

# (CG, HP, WP): ragged rows (WP 19, HP 7 and 20 against tiles of 8), an
# aligned 128-wide tile, and the experiments' (exp_dcn_inner_r04,
# exp_dcn_pack: 16 channels of a 64x128 tile)
PLAN_SHAPES = {"ragged": (6, 7, 19), "ragged_hp": (5, 20, 24),
               "aligned": (4, 16, 128), "experiments": (16, 64, 128)}
# element: (bytes, source dtype of the emulation, output dtype, output
# channels an element holds): E5 float32 and bfloat16, E6's x-pair words
# ("packed") and E1's channel-pair words ("cpair": CG words of 2 channels)
ELEMENTS = {"float32": (4, torch.float32, torch.float32, 1),
            "bfloat16": (2, torch.bfloat16, torch.bfloat16, 1),
            "packed": (4, torch.bfloat16, torch.bfloat16, 1),
            "cpair": (4, torch.bfloat16, torch.bfloat16, 2)}


def _admitted_rows(py, y0, tyn, band, dy_lo):
    """Slab rows of output rows [y0, y0 + tyn) that a tap inside the band
    reaches: floor(py) + s with band index in [0, band), as
    band_sampler._band_acc admits them."""
    y = torch.arange(y0, y0 + tyn, dtype=torch.float32)[:, None]
    rows = []
    for step in (0.0, 1.0):
        r = torch.floor(py[:, :, y0:y0 + tyn]) + step - (y + dy_lo)
        ok = (r >= 0) & (r < band)
        rows.append((r + y)[ok].long())
    return torch.cat(rows)


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
@pytest.mark.parametrize("element", list(ELEMENTS))
@pytest.mark.parametrize("band", [8, 16, 24, 48])
def test_plan_fits_and_blocks_equal_plain(band, element, shape):
    """The plan fits in 227 KB; its tiles' staged rows hold every slab row
    a band-admitted tap reaches; and band_sample_plain run one (i, y-tile,
    channel chunk) at a time on the staged rows alone, with NaN rows after
    them, is bit-equal to band_sample_plain on the whole source. For E1 the
    plan is made for CG channel-pair words of 4 bytes, and a chunk of words
    stages twice as many channels."""
    cg, hp, wp = PLAN_SHAPES[shape]
    esize, src_dtype, out_dtype, lanes = ELEMENTS[element]
    p = bs.plan(cg, hp, wp, band, esize)
    assert p.smem_bytes + 16 <= 232448                   # mbarriers: 16
    assert p.smem_bytes == (2 if p.nchunks > 1 else 1) * p.chunk * \
        p.slot_bytes
    assert p.slot_bytes >= (p.ty + band - 1) * wp * esize + 14
    assert p.nchunks == -(-cg // p.chunk) and 1 <= p.ty <= hp

    src, py, px, mask, dy_lo = _inputs(band, seed=5, ng=2, k=2,
                                       cg=lanes * cg, hp=hp, wp=wp)
    src = torch.from_numpy(src).to(src_dtype)
    if element == "packed":                              # E6's words
        src = bs.unpack_xpairs(bs.pack_xpairs(src))
    if element == "cpair":                               # E1's words
        src = bs.unpack_cpairs(bs.pack_cpairs(src))
    py, px, mask = map(torch.from_numpy, (py, px, mask))
    want = bs.band_sample_plain(src, py, px, mask, dy_lo, out_dtype)
    got = torch.full_like(want, float("nan"))
    tiles = list(p.tiles(hp, band))
    assert [t[1] for t in tiles] == [min(p.ty, hp - y0)
                                     for y0 in range(0, hp, p.ty)]
    for y0, tyn, rows in tiles:
        assert rows == min(tyn + band - 1, hp + band - y0)
        admitted = _admitted_rows(py, y0, tyn, band, dy_lo)
        assert ((admitted >= y0) & (admitted < y0 + rows)).all()
        for c0 in range(0, cg, p.chunk):               # the kernel's chunks
            cn = min(p.chunk, cg - c0)
            ch = slice(lanes * c0, lanes * (c0 + cn))
            slab = torch.full((2, lanes * cn, tyn + band, wp), float("nan"),
                              dtype=src_dtype)
            slab[:, :, :rows] = src[:, ch, y0:y0 + rows]
            # the tile's rows [y0, y0 + tyn) as rows [0, tyn) of the slab:
            # dy_lo + y0 keeps every band index r = floor(py) + s - (y +
            # dy_lo) exact
            got[:, :, ch, y0:y0 + tyn] = bs.band_sample_plain(
                slab, *(t[:, :, y0:y0 + tyn] for t in (py, px, mask)),
                dy_lo + y0, out_dtype)
    assert torch.equal(got, want)


def test_plan_picks_and_refuses():
    """The experiments' shapes at their bands, and a row too wide to
    stage even one channel of one output row."""
    for band, esize in ((24, 2), (24, 4), (48, 2), (48, 4)):
        p = bs.plan(16, 64, 128, band, esize)
        assert p.smem_bytes <= bs.SMEM_MAX
    with pytest.raises(ValueError, match="no plan fits"):
        bs.plan(1, 4, 1 << 16, 8, 4)
