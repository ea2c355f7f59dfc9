"""K3's plain version and the port's focal window attention against the JAX
package, float32, tolerance 2e-4; float32 emulations of the bf16 and the
float32 kernels' tile schedules against the plain version; the port's
static key and bias tables equal the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.kernels import fused_attention as jfa
from e2fgvi_tpu.models import tfocal as jtf
from e2fgvi_tpu_torch.kernels import focal_attention as fa
from e2fgvi_tpu_torch.models import tfocal

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)


def _kernel_inputs(rng, b=1, heads=2, nwin=2, t=2, s=16, hd=8, nq=16, no=8):
    """The JAX kernel's two-panel inputs."""
    q = rng.standard_normal((b * heads * nwin, nq, hd)).astype(np.float32)
    ko = rng.standard_normal((b * heads * nwin, no, hd)).astype(np.float32)
    vo = rng.standard_normal((b * heads * nwin, no, hd)).astype(np.float32)
    kg = rng.standard_normal((b * heads, t, nwin, s, hd)).astype(np.float32)
    vg = rng.standard_normal((b * heads, t, nwin, s, hd)).astype(np.float32)
    bias_o = np.where(rng.uniform(size=(b, 1, no)) < 0.2, -1e9,
                      0.0).astype(np.float32)
    bias_g = rng.choice(np.array([0.0, -100.0, np.log(2.0), -1e9],
                                 np.float32), size=(b * nwin, 1, t * s))
    bias_g[..., :2] = 0.0
    return q, ko, vo, kg, vg, bias_o, bias_g, b, heads


def _panel(q, ko, vo, kg, vg, bias_o, bias_g, b, heads):
    """The JAX kernel's inputs in the port's layout: per (b, head, window)
    one key panel [own keys | gathered keys frame by frame], one bias row
    per (b, window)."""
    bh, t, nwin, s, hd = kg.shape
    no = ko.shape[1]

    def join(own, gath):
        g = gath.reshape(b, heads, t, nwin, s, hd).transpose(0, 1, 3, 2, 4, 5)
        return np.concatenate(
            [own.reshape(b, heads, nwin, no, hd),
             g.reshape(b, heads, nwin, t * s, hd)], 3).reshape(
                 b * heads * nwin, no + t * s, hd)

    bias = np.concatenate(
        [np.broadcast_to(bias_o.reshape(b, 1, no), (b, nwin, no)),
         bias_g.reshape(b, nwin, t * s)], 2).reshape(b * nwin, no + t * s)
    return (torch.from_numpy(q), torch.from_numpy(join(ko, kg)),
            torch.from_numpy(join(vo, vg)), torch.from_numpy(bias), b, heads)


def test_k3_plain_matches_fused_interpret_and_xla(rng):
    *arrs, b, heads = _kernel_inputs(rng)
    want_k = jfa.fused_focal_attention(*map(jnp.asarray, arrs), b, heads,
                                       True)
    want_x = jfa._xla_reference(*map(jnp.asarray, arrs), b, heads)
    got = fa.focal_attention(*_panel(*arrs, b, heads)).numpy()
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_x), **TOL)


def test_k3_plain_matches_jax_at_serving_shape(rng):
    """One (b, window) pair per head at the base model's serving geometry:
    hd 128, nq = 17*45 queries, 765 own + 17*125 gathered keys."""
    *arrs, b, heads = _kernel_inputs(rng, b=1, heads=2, nwin=1, t=17, s=125,
                                     hd=128, nq=765, no=765)
    arrs[0] *= np.float32(128 ** -0.5)
    want_k = jfa.fused_focal_attention(*map(jnp.asarray, arrs), b, heads,
                                       True)
    want_x = jfa._xla_reference(*map(jnp.asarray, arrs), b, heads)
    got = fa.focal_attention(*_panel(*arrs, b, heads)).numpy()
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_x), **TOL)


def _tf32(x):
    """cvt.rna.tf32.f32: nearest tf32 (10 mantissa bits), ties away."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul(a, b, form):
    """a @ b with float32 sums: plain float32, or tensor-core products of
    tf32 operands (exact in float32), one pass or three."""
    if form == "f32":
        return a @ b
    a_big, b_big = _tf32(a), _tf32(b)
    if form == "1xtf32":
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def test_k3_3xtf32_split_keeps_float32_accuracy(rng):
    """The float32 K3 kernel's precision argument: splitting each operand
    into big + small tf32 parts keeps softmax(q k^T + bias) v as close to
    float64 as float32 products are; one TF32 pass does not."""
    q, ko, vo, kg, vg, bias_o, bias_g, _, _ = _kernel_inputs(
        rng, b=1, heads=1, nwin=1, t=2, s=100, hd=128, nq=64, no=100)
    q = q[0] * np.float32(128 ** -0.5)
    k = np.concatenate([ko[0], kg[0, :, 0].reshape(-1, 128)])
    v = np.concatenate([vo[0], vg[0, :, 0].reshape(-1, 128)])
    bias = np.concatenate([bias_o[0, 0], bias_g[0, 0]])

    def attend(form):
        s = _matmul(q, k.T, form) + bias
        p = np.exp(s - s.max(-1, keepdims=True))
        return _matmul(p, v, form) / p.sum(-1, keepdims=True)

    s64 = q.astype(np.float64) @ k.T.astype(np.float64) + bias
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    want = p64 @ v.astype(np.float64) / p64.sum(-1, keepdims=True)
    err = {f: np.abs(attend(f) - want).max()
           for f in ("f32", "3xtf32", "1xtf32")}
    assert attend("3xtf32").dtype == np.float32
    assert err["3xtf32"] <= 2 * err["f32"], err
    assert err["1xtf32"] >= 20 * err["f32"], err


def test_k3_plain_ragged_shapes(rng):
    """The port pads neither queries nor keys: odd counts everywhere."""
    *arrs, b, heads = _kernel_inputs(rng, b=2, heads=2, nwin=3, t=3, s=7,
                                     hd=8, nq=13, no=13)
    want = jfa._xla_reference(*map(jnp.asarray, arrs), b, heads)
    got = fa.focal_attention(*_panel(*arrs, b, heads)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _bf16(x):
    return x.bfloat16().float()


def _emulate_wgmma_kernel(q, k, v, bias, b, heads, bq=128, bk=128):
    """The bf16 kernel's schedule (csrc/focal_attention.cu, namespace
    hopper) in float32: 128-query blocks and 128-key tiles; rows past the
    panel's end read as zeros (TMA's out-of-bounds fill) with the wrapper's
    -inf bias padding; logits in base 2 with a running max and sum; P
    rounded to bf16 for P V, the row sums from the unrounded P."""
    log2e = np.float32(np.log2(np.e))
    panels, nq, hd = q.shape
    nk = k.shape[1]
    nwin = panels // (b * heads)
    bias_p = fa.padded_bias(bias)
    ld = bias_p.shape[1]
    kp = torch.zeros((panels, ld, hd))
    vp = torch.zeros((panels, ld, hd))
    kp[:, :nk], vp[:, :nk] = k, v
    nq_pad = -(-nq // bq) * bq
    qp = torch.zeros((panels, nq_pad, hd))
    qp[:, :nq] = q
    out = torch.empty((b * nwin, nq, heads * hd))
    for p in range(panels):
        bb, rem = divmod(p, heads * nwin)
        h, w = divmod(rem, nwin)
        brow = bias_p[bb * nwin + w]
        for q0 in range(0, nq_pad, bq):
            qt = qp[p, q0:q0 + bq]
            m = torch.full((bq, 1), float("-inf"))
            l = torch.zeros((bq, 1))
            o = torch.zeros((bq, hd))
            for k0 in range(0, ld, bk):
                s = (qt @ kp[p, k0:k0 + bk].T + brow[k0:k0 + bk]) * log2e
                m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                alpha = torch.exp2(m - m_new)
                pt = torch.exp2(s - m_new)
                l = l * alpha + pt.sum(1, keepdim=True)
                o = o * alpha + _bf16(pt) @ vp[p, k0:k0 + bk]
                m = m_new
            rows = min(bq, nq - q0)
            out[bb * nwin + w, q0:q0 + rows, h * hd:(h + 1) * hd] = (
                o / l)[:rows]
    return out


@pytest.mark.parametrize("case", ["serving", "ragged", "first_frame_only"])
def test_k3_bf16_tile_schedule_matches_plain(case):
    """The emulated kernel schedule on bf16-rounded inputs against the
    plain version at <= 1e-2 relative: catches an off-by-one in the key
    tiling, the query tiling or the masking before a run on the card.
    serving: nk = 765 + 17*125 = 2890, 22 full key tiles and a ragged one,
    nq = 765 over 6 query blocks; ragged: 129 queries and 129 keys (one
    past a tile each); first_frame_only: every key past the first
    frame's 45 own and 125 gathered ones at -1e9, so whole tiles of
    padding come after the first."""
    rng = np.random.default_rng(3)
    nq, nk, b, heads, nwin = {"serving": (765, 2890, 1, 1, 2),
                              "ragged": (129, 129, 2, 2, 1),
                              "first_frame_only": (765, 2890, 1, 2, 1)}[case]
    hd = 128
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal(
        (b * heads * nwin, n, hd)).astype(np.float32) * sc))
        for n, sc in ((nq, hd ** -0.5), (nk, 1.0), (nk, 1.0)))
    bias = torch.from_numpy(rng.choice(
        np.array([0.0, -100.0, np.log(2.0)], np.float32),
        size=(b * nwin, nk)))
    if case == "first_frame_only":
        keep = torch.zeros(nk, dtype=torch.bool)
        keep[:45] = True
        keep[765:765 + 125] = True
        bias = torch.where(keep, bias, torch.full_like(bias, -1e9))
    want = fa.focal_attention_plain(q, k, v, bias, b, heads)
    got = _emulate_wgmma_kernel(q, k, v, bias, b, heads)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() / want.abs().max() <= 1e-2


def _tf32_kernel_sizes():
    """(query block, key tile) of the float32 kernel, read from its source
    (csrc/focal_attention.cu, namespace attn_tf32)."""
    import re
    from pathlib import Path
    src = (Path(fa.__file__).resolve().parents[1] / "csrc" /
           "focal_attention.cu").read_text()
    body = src[src.index("namespace attn_tf32 {"):
               src.index("}  // namespace attn_tf32")]
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               body).group(1)) for name in ("kBQ", "kBK"))


def _split(x):
    """x = big + small, both rna tf32 (the kernel's split)."""
    big = _tf32(x)
    return big, _tf32(x - big)


def _emulate_tf32_wgmma_kernel(q, k, v, bias, b, heads):
    """The float32 kernel's schedule (csrc/focal_attention.cu, namespace
    attn_tf32) in numpy float32: its query blocks and key tiles, rows past
    the panel's end zeros (TMA's out-of-bounds fill) with the wrapper's
    -inf bias padding; Q, K, V and P split into rna tf32 big and small
    parts; the logits' big*big, big*small and small*big summed apart,
    big*big last; online softmax; P's A fragment columns and V^T's
    k-columns in the kernel's key orders (the fragment: column t is key 2t
    and t + 4 key 2t + 1 of an 8-key block; split V: warp w's chunk holds
    keys 8(w/2) + w%2 + 2u at columns 4w + u); each tile's P V from zero,
    joined by O = fma(O, alpha, PV)."""
    bq, bk = _tf32_kernel_sizes()
    q, k, v = (np.asarray(x, np.float32) for x in (q, k, v))
    panels, nq, hd = q.shape
    nk = k.shape[1]
    nwin = panels // (b * heads)
    bias_p = fa.padded_bias(torch.from_numpy(np.asarray(bias))).numpy()
    tiles = -(-nk // bk)
    kp = np.zeros((panels, tiles * bk, hd), np.float32)
    vp = np.zeros((panels, tiles * bk, hd), np.float32)
    kp[:, :nk], vp[:, :nk] = k, v
    nq_pad = -(-nq // bq) * bq
    qp = np.zeros((panels, nq_pad, hd), np.float32)
    qp[:, :nq] = q
    col = np.arange(bk)
    blk, c8 = col // 8 * 8, col % 8
    a_key = blk + np.where(c8 < 4, 2 * c8, 2 * (c8 - 4) + 1)
    w, u = col // 4, col % 4
    vt_key = 8 * (w // 2) + w % 2 + 2 * u
    out = np.empty((b * nwin, nq, heads * hd), np.float32)
    for p in range(panels):
        bb, rem = divmod(p, heads * nwin)
        h, win = divmod(rem, nwin)
        brow = bias_p[bb * nwin + win]
        for q0 in range(0, nq_pad, bq):
            qb, qs = _split(qp[p, q0:q0 + bq])
            m = np.full((bq, 1), -np.inf, np.float32)
            l = np.zeros((bq, 1), np.float32)
            o = np.zeros((bq, hd), np.float32)
            for k0 in range(0, tiles * bk, bk):
                kb, ks = _split(kp[p, k0:k0 + bk])
                s = (qb @ kb.T + (qb @ ks.T + qs @ kb.T)) + brow[k0:k0 + bk]
                m_new = np.maximum(m, s.max(1, keepdims=True))
                alpha = np.exp(m - m_new)
                pt = np.exp(s - m_new)
                l = l * alpha + pt.sum(1, keepdims=True)
                pb, ps = _split(pt[:, a_key])
                vb, vs = _split(vp[p, k0:k0 + bk][vt_key])
                acc = ps @ vb + pb @ vs + pb @ vb
                o = (o.astype(np.float64) * alpha + acc).astype(np.float32)
                m = m_new
            rows = min(bq, nq - q0)
            out[bb * nwin + win, q0:q0 + rows, h * hd:(h + 1) * hd] = (
                o / l)[:rows]
    return out


def _attend64(q, k, v, bias, b, heads):
    """focal_attention_plain's function in float64."""
    nq, hd = q.shape[1], q.shape[2]
    nk = k.shape[1]
    nwin = q.shape[0] // (b * heads)
    qf, kf, vf = (x.double().reshape(b, heads, nwin, -1, hd)
                  for x in (q, k, v))
    s = torch.einsum("bhwqd,bhwkd->bhwqk", qf, kf)
    s = s + bias.double().reshape(b, 1, nwin, 1, nk)
    o = torch.einsum("bhwqk,bhwkd->bhwqd", torch.softmax(s, dim=-1), vf)
    return o.permute(0, 2, 3, 1, 4).reshape(b * nwin, nq, heads * hd)


@pytest.mark.parametrize("case", ["serving", "ragged", "first_frame_only"])
def test_k3_f32_tile_schedule_matches_plain(case):
    """The emulated float32 kernel against the plain version at <= 1e-5
    max |delta| (chip_smoke.F32_MAX_ABS's bar for the kernel), and against
    float64 no worse than 2x the plain float32 version: catches a tiling,
    masking or key-order error before a run on the card. Cases as in
    test_k3_bf16_tile_schedule_matches_plain; the serving panel is 91
    32-key tiles, the last ragged; 129 keys end one key into a tile."""
    rng = np.random.default_rng(4)
    nq, nk, b, heads, nwin = {"serving": (765, 2890, 1, 1, 2),
                              "ragged": (129, 129, 2, 2, 1),
                              "first_frame_only": (765, 2890, 1, 2, 1)}[case]
    hd = 128
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b * heads * nwin, n, hd)).astype(np.float32) * np.float32(sc))
        for n, sc in ((nq, hd ** -0.5), (nk, 1.0), (nk, 1.0)))
    bias = torch.from_numpy(rng.choice(
        np.array([0.0, -100.0, np.log(2.0)], np.float32),
        size=(b * nwin, nk)))
    if case == "first_frame_only":
        keep = torch.zeros(nk, dtype=torch.bool)
        keep[:45] = True
        keep[765:765 + 125] = True
        bias = torch.where(keep, bias, torch.full_like(bias, -1e9))
    want = fa.focal_attention_plain(q, k, v, bias, b, heads)
    want64 = _attend64(q, k, v, bias, b, heads)
    got = torch.from_numpy(_emulate_tf32_wgmma_kernel(q, k, v, bias, b,
                                                      heads))
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-5
    err_plain = (want.double() - want64).abs().max()
    assert (got.double() - want64).abs().max() <= 2 * err_plain


def _attn_params(rng, c):
    def lin(cin, cout, std):
        return {"w": (rng.standard_normal((cin, cout)) * std).astype(np.float32),
                "b": (rng.standard_normal(cout) * 0.1).astype(np.float32)}
    return {"qkv": lin(c, 3 * c, 0.2), "proj": lin(c, c, 0.2),
            "pool": lin(45, 1, 0.2)}


def _torch_attn(p, c):
    m = tfocal.WindowAttention(c)
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(m, name).weight.copy_(torch.from_numpy(p[name]["w"].T))
            getattr(m, name).bias.copy_(torch.from_numpy(p[name]["b"]))
    return m


@pytest.mark.parametrize("frame_valid", [False, True])
def test_window_attention_matches_jax_xla(monkeypatch, frame_valid):
    """At the geometry of tests/test_fused_attention.py."""
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
        got = tfocal.window_attention(
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


def test_pool_level_matches_jax(rng):
    p = _attn_params(rng, 16)
    x = rng.standard_normal((2, 3, 22, 34, 16)).astype(np.float32)
    want = jtf._pool_level(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           (5, 9))
    blk = tfocal.TemporalFocalTransformerBlock(16, (5, 9), 49)
    with torch.no_grad():
        blk.pool_layers[0].weight.copy_(torch.from_numpy(p["pool"]["w"].T))
        blk.pool_layers[0].bias.copy_(torch.from_numpy(p["pool"]["b"]))
        got = tfocal._pool_level(blk, torch.from_numpy(x), (5, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


SERVING = (20, 36, 5, 9, 2, 4)
POOLED = (4, 4, 5, 9, 2, 4)


@pytest.mark.parametrize("table", ["rolled", "pooled_mask", "gather",
                                   "dedup"])
def test_tables_equal_jax_at_serving_geometry(table):
    h, w, wh, ww, eh, ew = SERVING
    if table == "rolled":
        pairs = [(tfocal._rolled_valid_idx(wh, ww, eh, ew),
                  jtf._rolled_valid_idx(wh, ww, eh, ew))]
    elif table == "pooled_mask":
        pairs = [(tfocal._pooled_key_mask(*POOLED),
                  jtf._pooled_key_mask(*POOLED))]
    elif table == "gather":
        got, gn = tfocal._key_gather_idx(*SERVING, POOLED)
        want, wn = jtf._key_gather_idx(*SERVING, POOLED)
        assert gn == wn
        pairs = [(got, want)]
    else:
        pairs = list(zip(tfocal._key_gather_dedup(*SERVING, POOLED),
                         jtf._key_gather_dedup(*SERVING, POOLED)))
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
