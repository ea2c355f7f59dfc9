"""K3's plain version and the port's focal window attention against the JAX
package, float32, tolerance 2e-4; the port's static key and bias tables
equal the JAX package's."""

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


def test_k3_plain_matches_fused_interpret_and_xla(rng):
    *arrs, b, heads = _kernel_inputs(rng)
    want_k = jfa.fused_focal_attention(*map(jnp.asarray, arrs), b, heads,
                                       True)
    want_x = jfa._xla_reference(*map(jnp.asarray, arrs), b, heads)
    got = fa.focal_attention(*map(torch.from_numpy, arrs), b, heads).numpy()
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_x), **TOL)


def test_k3_plain_ragged_shapes(rng):
    """The port pads neither queries nor keys: odd counts everywhere."""
    *arrs, b, heads = _kernel_inputs(rng, b=2, heads=2, nwin=3, t=3, s=7,
                                     hd=8, nq=13, no=13)
    want = jfa._xla_reference(*map(jnp.asarray, arrs), b, heads)
    got = fa.focal_attention(*map(torch.from_numpy, arrs), b, heads).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


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
