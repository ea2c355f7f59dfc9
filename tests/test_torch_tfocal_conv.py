"""The conv forms of soft comp and the F3N feed-forward: the port's
soft_comp and fusion_feed_forward against the JAX package's conv forms
(_tokens_to_pixels_conv plus its bias, _fusion_feed_forward_conv) on the
same converted weights, and against the port's own literal chains in value
and gradient; float32, hidden 32, on feature maps whose (H-1) % 3 and
(W-1) % 3 take 0, 1 and 2. The tolerance is the JAX package's own
conv-vs-gemm bound (tests/test_tfocal.py test_f3n_conv_equals_gemm). A
base generator forward with F.fold and F.unfold disabled still meets the
reference golden: nothing on the path folds."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e2fgvi_tpu.models import tfocal as jtf
from e2fgvi_tpu.ops import convs as jconvs
from e2fgvi_tpu_torch.convert import from_jax
from e2fgvi_tpu_torch.models import e2fgvi as tgen
from e2fgvi_tpu_torch.models import tfocal
from e2fgvi_tpu_torch.ops import patches
from test_generator_golden import fill_weight

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
B, T, CC, HIDDEN = 2, 2, 8, 32
# (H, W): (H-1) % 3 and (W-1) % 3 are (2, 0), (0, 1) and (1, 2)
SIZES = [(30, 31), (31, 32), (32, 33)]
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "goldens", "generator_base.npz")


def _normal(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _soft_comp_params(rng, size, variant):
    """JAX-layout soft comp params (k-major patches) and the port's
    SoftComp loaded with the same weights by the converter."""
    sc = {"embedding": {"w": _normal(rng, (HIDDEN, 49 * CC), 0.1),
                        "b": _normal(rng, (49 * CC,), 0.1)}}
    sd = from_jax._patch_linear_out(sc["embedding"], "embedding", CC)
    if variant == "base":
        sc["bias"] = _normal(rng, (*size, CC), 1.0)
        sd["bias"] = sc["bias"].transpose(2, 0, 1)
        module = tfocal.SoftComp(CC, HIDDEN, size)
    else:
        sc["bias_conv"] = {"w": _normal(rng, (3, 3, CC, CC), 0.1),
                           "b": _normal(rng, (CC,), 0.1)}
        sd.update(from_jax._conv(sc["bias_conv"], "bias_conv"))
        module = tfocal.SoftComp(CC, HIDDEN)
    module.load_state_dict(from_jax.to_torch(sd), strict=True)
    return sc, module


def _f3n_params(rng):
    mlp = {"fc1": {"w": _normal(rng, (HIDDEN, 49 * CC), 0.1),
                   "b": _normal(rng, (49 * CC,), 1.0)},
           "fc2": {"w": _normal(rng, (49 * CC, HIDDEN), 0.1),
                   "b": _normal(rng, (HIDDEN,), 1.0)}}
    sd = from_jax._patch_linear_out(mlp["fc1"], "conv1.0", CC)
    sd.update(from_jax._patch_linear_in(mlp["fc2"], "conv2.1", CC))
    module = tfocal.FusionFeedForward(HIDDEN, 49 * CC)
    module.load_state_dict(from_jax.to_torch(sd), strict=True)
    return mlp, module


def _jax_soft_comp_conv(sc, tok, size):
    """The JAX package's soft comp in its conv form: _tokens_to_pixels_conv,
    then the bias map or the bias conv."""
    sc = jax.tree.map(jnp.asarray, sc)
    b, t, lh, lw, hidden = tok.shape
    out = jtf._tokens_to_pixels_conv(
        jnp.asarray(tok.reshape(b * t, lh, lw, hidden)),
        sc["embedding"]["w"], sc["embedding"]["b"], size)
    if "bias" in sc:
        return np.asarray(out + sc["bias"][None])
    return np.asarray(jconvs.conv2d(out, sc["bias_conv"]["w"],
                                    sc["bias_conv"]["b"], padding=1))


def _no_copy(out):
    """A contiguous channel-last result that is a view of what the last
    convolution wrote: no layout copy on the way out."""
    return out.is_contiguous() and out._base is not None


@pytest.mark.parametrize("variant", ["base", "hq"])
@pytest.mark.parametrize("size", SIZES)
def test_soft_comp_matches_jax_conv_form(rng, size, variant):
    sc, module = _soft_comp_params(rng, size, variant)
    lh, lw = tfocal.token_grid(size)
    tok = rng.standard_normal((B, T, lh, lw, HIDDEN)).astype(np.float32)
    want = _jax_soft_comp_conv(sc, tok, size)
    with torch.no_grad():
        got = tfocal.soft_comp(module, torch.from_numpy(tok), T, size)
        literal = tfocal._soft_comp_literal(module, torch.from_numpy(tok), T,
                                            size)
    assert got.shape == (B * T, *size, CC) and _no_copy(got)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), literal.numpy(), **TOL)


@pytest.mark.parametrize("size", SIZES)
def test_fusion_feed_forward_matches_jax_conv_form(rng, size):
    mlp, module = _f3n_params(rng)
    lh, lw = tfocal.token_grid(size)
    x = rng.standard_normal((B, T * lh * lw, HIDDEN)).astype(np.float32)
    want = np.asarray(jtf._fusion_feed_forward_conv(
        jax.tree.map(jnp.asarray, mlp), jnp.asarray(x), T, size))
    with torch.no_grad():
        got = tfocal.fusion_feed_forward(module, torch.from_numpy(x), T,
                                         size)
        literal = tfocal._fusion_feed_forward_literal(
            module, torch.from_numpy(x), T, size)
    assert got.shape == x.shape and _no_copy(got)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), literal.numpy(), **TOL)


def _grads(fn, module, inp, g):
    """d(sum(fn(inp) * g)) by the input and every parameter."""
    module.zero_grad()
    x = inp.clone().requires_grad_(True)
    (fn(x) * g).sum().backward()
    return [x.grad] + [p.grad.clone() for p in module.parameters()]


@pytest.mark.parametrize("form", ["soft_comp base", "soft_comp hq", "f3n"])
@pytest.mark.parametrize("size", SIZES)
def test_conv_form_gradients_match_literal(rng, size, form):
    """Autograd through the conv form and through the literal chain: each
    gradient within 2e-5 of the other, relative to its largest entry (the
    two sum the same float32 terms in different orders)."""
    lh, lw = tfocal.token_grid(size)
    if form == "f3n":
        _, module = _f3n_params(rng)
        inp = torch.from_numpy(rng.standard_normal(
            (B, T * lh * lw, HIDDEN)).astype(np.float32))
        pair = (tfocal.fusion_feed_forward,
                tfocal._fusion_feed_forward_literal)
    else:
        _, module = _soft_comp_params(rng, size, form.split()[1])
        inp = torch.from_numpy(rng.standard_normal(
            (B, T, lh, lw, HIDDEN)).astype(np.float32))
        pair = (tfocal.soft_comp, tfocal._soft_comp_literal)
    conv_fn, literal_fn = (lambda x, f=f: f(module, x, T, size) for f in pair)
    with torch.no_grad():
        g = torch.randn(conv_fn(inp).shape,
                        generator=torch.Generator().manual_seed(1))
    got = _grads(conv_fn, module, inp, g)
    want = _grads(literal_fn, module, inp, g)
    assert len(got) == len(want) == 1 + len(list(module.parameters()))
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("size", [(60, 108), (31, 55)])
def test_fold_maps_match_f_fold(size):
    """The counts and the folded bias map, built by transposed
    convolutions, equal F.fold of the broadcast patches."""
    k, s, p = tfocal.T2T_KERNEL, tfocal.T2T_STRIDE, tfocal.T2T_PADDING
    lh, lw = tfocal.token_grid(size)
    cnt = patches.fold_counts(size, k, s, p)
    assert cnt.dtype == torch.float32 and cnt.shape == (1, 1, *size)
    assert cnt is patches.fold_counts(size, k, s, p)        # cached
    ones = torch.ones((1, 49, lh * lw))
    torch.testing.assert_close(cnt, F.fold(ones, size, k, padding=p, stride=s),
                               rtol=0, atol=0)
    bias = torch.randn(CC * 49, generator=torch.Generator().manual_seed(2))
    want = F.fold(bias[None, :, None].expand(1, CC * 49, lh * lw).contiguous(),
                  size, k, padding=p, stride=s)
    torch.testing.assert_close(patches.fold_bias(bias, size, k, s, p), want,
                               **TOL)


def test_fold_counts_are_usable_by_autograd_after_inference_mode():
    size = (29, 41)
    k, s, p = tfocal.T2T_KERNEL, tfocal.T2T_STRIDE, tfocal.T2T_PADDING
    with torch.inference_mode():
        cnt = patches.fold_counts(size, k, s, p)
    assert not cnt.is_inference()
    z = torch.ones((1, 1, *size), requires_grad=True)
    (z / cnt).sum().backward()
    torch.testing.assert_close(z.grad, 1 / cnt)


def test_base_generator_runs_without_fold(monkeypatch):
    """The reference golden's base generator forward with F.fold and
    F.unfold made to raise: soft split, soft comp and every F3N take the
    conv forms, and the output still meets the golden."""
    data = np.load(GOLDEN)
    keys = [str(k) for k in data["keys"]]
    shapes = [ast.literal_eval(str(s)) for s in data["shapes"]]
    wrng = np.random.default_rng(7)
    model = tgen.Generator()
    model.load_state_dict({k: torch.from_numpy(fill_weight(k, s, wrng))
                           for k, s in zip(keys, shapes)}, strict=True)

    def refuse(*args, **kwargs):
        raise AssertionError("F.fold / F.unfold called")

    monkeypatch.setattr(F, "fold", refuse)
    monkeypatch.setattr(F, "unfold", refuse)
    t, lt = int(data["t"]), int(data["lt"])
    h, w = int(data["h"]), int(data["w"])
    frames = np.random.default_rng(11).uniform(
        -1, 1, (1, t, 3, h, w)).astype(np.float32)
    with torch.no_grad():
        out, _ = tgen.generator_forward(
            model.eval(),
            torch.from_numpy(frames.transpose(0, 1, 3, 4, 2).copy()), lt)
    got = out.numpy().transpose(0, 3, 1, 2)[:, :, ::5, ::7]
    want = data["out_slice"]
    assert np.abs(got - want).max() < 2e-3 * np.abs(want).max() + 2e-5


@pytest.mark.parametrize("size", SIZES + [(60, 108)])
def test_subpixel_yardstick_equals_conv_form(rng, size):
    """chip_smoke.py times the JAX package's sub-pixel form of the token ->
    pixel map beside the port's transposed convolution: the two agree."""
    from chip_smoke import subpixel_tokens_to_pixels
    _, module = _soft_comp_params(rng, size, "hq")
    lh, lw = tfocal.token_grid(size)
    xt = torch.from_numpy(rng.standard_normal(
        (B * T, lh, lw, HIDDEN)).astype(np.float32))
    lin = module.embedding
    with torch.no_grad():
        got = subpixel_tokens_to_pixels(xt, lin.weight, lin.bias, size)
        want = tfocal._tokens_to_pixels(xt, lin.weight, lin.bias, size)
    assert got.shape == want.shape == (B * T, CC, *size)
    torch.testing.assert_close(got, want, **TOL)
