"""E2: the port's _rolled_rects and slot tables, band_attention's plain
form and the kernel's table addressing (done in torch here) against the
JAX package's window_attention (E2FGVI_ATTENTION=xla), float32, tolerance
2e-4; and the wrapper's refusals, which come before any CUDA call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _jax_pooled_geom(h, w, wh, ww):
    nwy, nwx = h // wh, w // ww
    pk = (2 * (wh // 2) + 1, 2 * (ww // 2) + 1)
    return (nwy, nwx, pk[0], pk[1], pk[0] // 2, pk[1] // 2)


@pytest.mark.parametrize("geom", [(20, 36, 5, 9, 2, 4), (12, 18, 4, 6, 1, 3)])
def test_slot_tables_match_the_gather_table(geom):
    """Per window, the kernel's source rows are the JAX key table's
    multiset (_key_gather_idx: fine tokens, then pooled cells, the zero
    slot outside the grid), and the -100 biases are _pooled_key_mask's."""
    h, w, wh, ww, eh, ew = geom
    pgeom = _jax_pooled_geom(h, w, wh, ww)
    want, n_fine_j = jtf._key_gather_idx(h, w, wh, ww, eh, ew, pgeom)
    src, bias, n_fine = ba.slot_tables(h, w, wh, ww, eh, ew)
    assert src.dtype == np.int32 and bias.dtype == np.float32
    assert n_fine == n_fine_j and src.shape == want.shape == bias.shape
    zero_slot = h * w + pgeom[0] * pgeom[1]
    pooled = src[:, n_fine:]
    assert (src[:, :n_fine] >= 0).all() and (src[:, :n_fine] < h * w).all()
    got = np.concatenate([src[:, :n_fine], np.where(
        pooled >= 0, h * w + pooled, zero_slot)], 1)
    for row_got, row_want in zip(got, want):
        assert sorted(row_got.tolist()) == sorted(row_want.tolist())
    np.testing.assert_array_equal(bias[:, :n_fine], 0.0)
    np.testing.assert_array_equal(bias[:, n_fine:],
                                  jtf._pooled_key_mask(*pgeom))
    np.testing.assert_array_equal(bias[:, n_fine:] == -100.0, pooled < 0)


def _table_attention(attn, x, pooled, heads, window, expand, fv):
    """The kernel's function through its addressing, in float32: key j of
    a window is slot j % S of frame j // S, read from the qkv maps at the
    slot table's source row (a zero key at -1); its bias is the slot's, or
    -1e9 in an invalid frame. Queries are the window's tokens frame by
    frame, scaled by 1/sqrt(hd)."""
    b, t, h, w, c = x.shape
    wh, ww = window
    hd = c // heads
    src, sbias, n_fine = ba.slot_tables(h, w, wh, ww, *expand)
    src, sbias = torch.as_tensor(src), torch.as_tensor(sbias)
    nwin, s = src.shape
    ncell = pooled.shape[1] * pooled.shape[2]
    qkv = F.linear(x, attn.qkv.weight, attn.qkv.bias).reshape(b, -1, 3 * c)
    pqkv = F.linear(pooled, attn.qkv.weight, attn.qkv.bias).reshape(
        b, ncell * t, 3 * c)                   # row cell * T + frame
    rows = torch.cat([qkv, pqkv, qkv.new_zeros((b, 1, 3 * c))], 1)
    j = torch.arange(t * s)
    tj, sj = j // s, j % s
    sr = src[:, sj]                            # (nWin, T*S)
    idx = torch.where(sj < n_fine, tj * h * w + sr,
                      torch.where(sr >= 0, t * h * w + sr * t + tj,
                                  t * h * w + ncell * t))
    keys = rows[:, idx]                        # (B, nWin, T*S, 3C)
    bias = sbias[:, sj].expand(b, nwin, t * s)
    if fv is not None:
        bias = torch.where(fv[:, None, tj], bias, torch.tensor(-1e9))
    n = torch.arange(t * wh * ww)
    tq, rem = n // (wh * ww), n % (wh * ww)
    wy, wx = torch.arange(nwin) // (w // ww), torch.arange(nwin) % (w // ww)
    qi = (tq * h * w + (wy[:, None] * wh + rem // ww) * w
          + wx[:, None] * ww + rem % ww)       # (nWin, nq)
    q = qkv[:, qi, :c].reshape(b, nwin, -1, heads, hd) * hd ** -0.5
    k = keys[..., c:2 * c].reshape(b, nwin, -1, heads, hd)
    v = keys[..., 2 * c:].reshape(b, nwin, -1, heads, hd)
    logits = torch.einsum("bwqhd,bwkhd->bwhqk", q, k) + bias[:, :, None, None]
    o = torch.einsum("bwhqk,bwkhd->bwqhd", torch.softmax(logits, -1), v)
    return F.linear(o.reshape(b * nwin, -1, c), attn.proj.weight,
                    attn.proj.bias)


@pytest.mark.parametrize("frame_valid", ["none", "partial", "element"])
def test_table_addressing_matches_jax_xla(monkeypatch, frame_valid):
    """"element": batch element 1 has no valid frame; its outputs (a
    uniform softmax over every key) must be finite, and are discarded from
    the comparison as a caller discards them."""
    b, t, h, w, c, heads = 2, 4, 10, 18, 64, 2
    rng = np.random.default_rng(3)
    p = _attn_params(rng, c)
    x = rng.standard_normal((b, t, h, w, c)).astype(np.float32)
    pooled = np.array(jtf._pool_level(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), (5, 9)))
    fv = None
    if frame_valid != "none":
        fv = np.ones((b, t), np.bool_)
        fv[0, -1] = False
        if frame_valid == "partial":
            fv[1, :2] = False
        else:
            fv[1] = False
    monkeypatch.setenv("E2FGVI_ATTENTION", "xla")
    want = np.asarray(jtf.window_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pooled),
        heads, (5, 9), (2, 4),
        frame_valid=None if fv is None else jnp.asarray(fv)))
    with torch.no_grad():
        got = _table_attention(
            _torch_attn(p, c), torch.from_numpy(x), torch.from_numpy(pooled),
            heads, (5, 9), (2, 4),
            None if fv is None else torch.from_numpy(fv)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    if fv is not None:
        nwin = want.shape[0] // b
        valid_q = np.repeat(np.repeat(fv, 45, axis=1), nwin, axis=0)
        got = np.where(valid_q[..., None], got, 0.0)
        want = np.where(valid_q[..., None], want, 0.0)
    np.testing.assert_allclose(got, want, **TOL)


_REFUSED = {
    # (dtype, C, heads, (H, W), frame_valid shape), the message
    "float32": ((torch.float32, 256, 2, (10, 18), None), "bfloat16"),
    "head_dim_64": ((torch.bfloat16, 128, 2, (10, 18), None), "head dim"),
    "untiled": ((torch.bfloat16, 256, 2, (10, 17), None), "tile"),
    "frame_valid": ((torch.bfloat16, 256, 2, (10, 18), (2, 4)),
                    "frame_valid"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_band_attention_refuses_before_any_cuda_call(monkeypatch, case):
    """Tensors off the CPU take the kernel's path; what the kernel does not
    take is refused from shapes and dtypes alone (meta tensors here), with
    the kernel library never loaded."""
    (dtype, c, heads, (h, w), fv_shape), msg = _REFUSED[case]

    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(ba.build, "library", no_library)
    b, t = 2, 3
    x = torch.empty((b, t, h, w, c), dtype=dtype, device="meta")
    pooled = torch.empty((b, h // 5, w // 9, t, c), dtype=dtype,
                         device="meta")
    fv = (None if fv_shape is None
          else torch.ones(fv_shape, dtype=torch.bool, device="meta"))
    attn = tfocal.WindowAttention(c)
    with pytest.raises(ValueError, match=msg):
        ba.band_attention(attn, x, pooled, heads, (5, 9), (2, 4),
                          frame_valid=fv)
    qkv = torch.empty((b, t, h, w, 3 * c), dtype=dtype, device="meta")
    pqkv = torch.empty((b, h // 5, w // 9, t, 3 * c), dtype=dtype,
                       device="meta")
    with pytest.raises(ValueError, match=msg):
        ba.band_attention_kernel(qkv, pqkv, heads, (5, 9), (2, 4),
                                 frame_valid=fv)
