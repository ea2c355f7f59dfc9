"""The port's SPyNet, bidirectional propagation (with end-padded windows)
and transformer block against the JAX package at narrow widths, float32,
tolerance 2e-4. On the CPU the propagation's K1/K2 and the block's K3 run
their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.models import feat_prop as jfp
from e2fgvi_tpu.models import spynet as jsp
from e2fgvi_tpu.models import tfocal as jtf
from e2fgvi_tpu_torch.convert import from_jax
from e2fgvi_tpu_torch.models import feat_prop, spynet, tfocal

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, sd):
    module.load_state_dict(from_jax.to_torch(sd), strict=True)
    return module


def test_spynet_matches_jax(rng):
    params = jsp.init_params(jax.random.PRNGKey(3))
    # a quieter pyramid than He init keeps the random flows moderate
    params = jax.tree.map(lambda a: a * 0.3, params)
    ref = rng.uniform(0, 1, (2, 40, 72, 3)).astype(np.float32)
    supp = np.roll(ref, (2, 3), axis=(1, 2)).copy()
    want = np.asarray(jsp.spynet_flow(params, jnp.asarray(ref),
                                      jnp.asarray(supp)))
    model = _load(spynet.SPyNet(),
                  from_jax.spynet_state(_np_tree(params), prefix=""))
    with torch.no_grad():
        got = model(torch.from_numpy(ref), torch.from_numpy(supp)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _conv(rng, kh, cin, cout, scale=0.05):
    return {"w": (rng.standard_normal((kh, kh, cin, cout)) * scale
                  ).astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.1).astype(np.float32)}


def _feat_prop_params(rng, c, g):
    p = {}
    for i, d in enumerate(("backward", "forward")):
        p[d] = {
            "deform": {**_conv(rng, 3, 2 * c, c),
                       "conv_offset": [_conv(rng, 3, 3 * c + 4, c),
                                       _conv(rng, 3, c, c),
                                       _conv(rng, 3, c, c),
                                       _conv(rng, 3, c, 27 * g)]},
            "backbone": [_conv(rng, 3, (2 + i) * c, c), _conv(rng, 3, c, c)],
        }
    p["fusion"] = _conv(rng, 1, 2 * c, c)
    return p


@pytest.mark.parametrize("valid", [None, (4, 2)])
def test_bidirectional_propagation_matches_jax(rng, valid):
    """C=32 with 16 deform groups; valid=(4, 2) end-pads the second window
    (the backward pass's cold start at its first real step)."""
    b, t, h, w, c, g = 2, 4, 10, 12, 32, 16
    params = _feat_prop_params(rng, c, g)
    x = rng.standard_normal((b, t, h, w, c)).astype(np.float32)
    fb = (rng.standard_normal((b, t - 1, h, w, 2)) * 2).astype(np.float32)
    ff = (rng.standard_normal((b, t - 1, h, w, 2)) * 2).astype(np.float32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    want = np.asarray(jfp.bidirectional_propagation(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(fb),
        jnp.asarray(ff), valid_len=None if vl is None else jnp.asarray(vl)))
    model = _load(feat_prop.FeatPropModule(c, g),
                  from_jax.feat_prop_state(params, prefix=""))
    with torch.no_grad():
        got = feat_prop.bidirectional_propagation(
            model, torch.from_numpy(x), torch.from_numpy(fb),
            torch.from_numpy(ff),
            valid_len=None if vl is None else torch.from_numpy(vl)).numpy()
    for i in range(b):
        n = t if vl is None else vl[i]      # padded frames are discarded
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)


def _block_params(rng, c, d_ff):
    def lin(cin, cout, std=0.1):
        return {"w": (rng.standard_normal((cin, cout)) * std).astype(np.float32),
                "b": (rng.standard_normal(cout) * 0.05).astype(np.float32)}

    def norm():
        return {"g": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    return {"norm1": norm(), "norm2": norm(),
            "attn": {"qkv": lin(c, 3 * c, 0.2), "proj": lin(c, c)},
            "mlp": {"fc1": lin(c, d_ff), "fc2": lin(d_ff, c)},
            "pool": lin(45, 1, 0.2)}


@pytest.mark.parametrize("frame_valid", [False, True])
def test_transformer_block_matches_jax(rng, frame_valid):
    b, t, fh, fw, c, heads, d_ff = 2, 3, 10, 18, 64, 2, 49 * 8
    out_size = (30, 54)
    params = _block_params(rng, c, d_ff)
    x = rng.standard_normal((b, t, fh, fw, c)).astype(np.float32)
    fv = np.ones((b, t), np.bool_)
    fv[1, -1] = False
    fvj = jnp.asarray(fv) if frame_valid else None
    want = np.asarray(jtf.transformer_block(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), out_size,
        num_heads=heads, frame_valid=fvj))
    blk = _load(tfocal.TemporalFocalTransformerBlock(c, (5, 9), d_ff),
                from_jax.block_state(params))
    with torch.no_grad():
        got = tfocal.transformer_block(
            blk, torch.from_numpy(x), out_size, heads,
            frame_valid=torch.from_numpy(fv) if frame_valid else None
        ).numpy()
    if frame_valid:
        got, want = got[fv], want[fv]
    np.testing.assert_allclose(got, want, **TOL)


def test_soft_split_and_comp_match_jax(rng):
    b, t, c, hidden = 2, 2, 8, 32
    out_size = (30, 54)
    ss = {"embedding": {
        "w": (rng.standard_normal((49 * c, hidden)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(hidden) * 0.1).astype(np.float32)}}
    sc = {"embedding": {
        "w": (rng.standard_normal((hidden, 49 * c)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(49 * c) * 0.1).astype(np.float32)},
        "bias": rng.standard_normal((*out_size, c)).astype(np.float32)}
    x = rng.standard_normal((b * t, *out_size, c)).astype(np.float32)
    tok_j = jtf.soft_split(jax.tree.map(jnp.asarray, ss), jnp.asarray(x), b)
    want = np.asarray(jtf.soft_comp(jax.tree.map(jnp.asarray, sc), tok_j, t,
                                    out_size))

    tss = _load(tfocal.SoftSplit(c, hidden), from_jax._patch_linear_in(
        ss["embedding"], "embedding", c))
    sd = from_jax._patch_linear_out(sc["embedding"], "embedding", c)
    sd["bias"] = sc["bias"].transpose(2, 0, 1)
    tsc = _load(tfocal.SoftComp(c, hidden, out_size), sd)
    with torch.no_grad():
        tok = tfocal.soft_split(tss, torch.from_numpy(x), b)
        np.testing.assert_allclose(tok.numpy(), np.asarray(tok_j), **TOL)
        got = tfocal.soft_comp(tsc, tok, t, out_size).numpy()
    np.testing.assert_allclose(got, want, **TOL)
