"""E2: the port's _rolled_rects and slot table, and band_attention's plain
form against the JAX package's window_attention (E2FGVI_ATTENTION=xla),
float32, tolerance 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.models import tfocal as jtf
from e2fgvi_tpu_torch.kernels import band_attention as ba
from e2fgvi_tpu_torch.models import tfocal

from test_torch_attention import _attn_params, _torch_attn

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("geom", [(5, 9, 2, 4), (4, 6, 1, 3)])
def test_rolled_rects_equal_jax(geom):
    assert tfocal._rolled_rects(*geom) == jtf._rolled_rects(*geom)


@pytest.mark.parametrize("geom", [(20, 36, 5, 9, 2, 4), (12, 18, 4, 6, 1, 3)])
def test_slot_offsets_cover_the_gather_table(geom):
    """Per window, the slots' sources are the JAX key table's multiset
    (own + rolled + pooled, _key_gather_idx), slot for slot up to order."""
    h, w, wh, ww, eh, ew = geom
    nwy, nwx = h // wh, w // ww
    pk = (2 * (wh // 2) + 1, 2 * (ww // 2) + 1)
    pooled_geom = (nwy, nwx, pk[0], pk[1], pk[0] // 2, pk[1] // 2)
    want, n_fine_j = jtf._key_gather_idx(h, w, wh, ww, eh, ew, pooled_geom)
    offsets, n_fine = ba.slot_offsets(wh, ww, eh, ew)
    assert n_fine == n_fine_j and offsets.shape[0] == want.shape[1]
    zero_slot = h * w + nwy * nwx
    for wy in range(nwy):
        for wx in range(nwx):
            got = []
            for s, (dy, dx) in enumerate(offsets):
                if s < n_fine:
                    got.append(((wy * wh + dy) % h) * w + (wx * ww + dx) % w)
                else:
                    py, px = wy + dy, wx + dx
                    ok = 0 <= py < nwy and 0 <= px < nwx
                    got.append(h * w + py * nwx + px if ok else zero_slot)
            assert sorted(got) == sorted(want[wy * nwx + wx].tolist())


@pytest.mark.parametrize("frame_valid", [False, True])
def test_band_attention_plain_matches_jax_xla(monkeypatch, frame_valid):
    """At the geometry of tests/test_torch_attention.py."""
    b, t, h, w, c, heads = 2, 4, 10, 18, 64, 2
    rng = np.random.default_rng(0)
    p = _attn_params(rng, c)
    x = rng.standard_normal((b, t, h, w, c)).astype(np.float32)
    pooled = np.array(jtf._pool_level(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), (5, 9)))
    fv = None
    if frame_valid:
        fv = np.ones((b, t), np.bool_)
        fv[0, -1] = False
        fv[1, -2:] = False
    monkeypatch.setenv("E2FGVI_ATTENTION", "xla")
    want = np.asarray(jtf.window_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pooled),
        heads, (5, 9), (2, 4),
        frame_valid=None if fv is None else jnp.asarray(fv)))
    with torch.no_grad():
        got = ba.band_attention(
            _torch_attn(p, c), torch.from_numpy(x), torch.from_numpy(pooled),
            heads, (5, 9), (2, 4),
            frame_valid=None if fv is None else torch.from_numpy(fv)).numpy()
    if fv is not None:
        # padding frames' own outputs are discarded by the caller
        nwin = want.shape[0] // b
        valid_q = np.repeat(np.repeat(fv, 45, axis=1), nwin, axis=0)
        got = np.where(valid_q[..., None], got, 0.0)
        want = np.where(valid_q[..., None], want, 0.0)
    np.testing.assert_allclose(got, want, **TOL)


def test_band_attention_refuses_untiled_geometry():
    attn = tfocal.WindowAttention(8)
    x = torch.zeros((1, 2, 10, 17, 8))
    pooled = torch.zeros((1, 2, 1, 2, 8))
    with pytest.raises(ValueError, match="tile"):
        ba.band_attention(attn, x, pooled, 2, (5, 9), (2, 4))
