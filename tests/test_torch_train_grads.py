"""Gradients of the port's training path against the JAX package's, on
seeded numpy inputs and a seeded cotangent:

- the plain K1 (kernels/deform.modulated_deform_conv2d) against jax.vjp of
  e2fgvi_tpu/ops/dcn.modulated_deform_conv2d, in x, the offsets, the mask,
  the weight and the bias: 1e-5 relative norm each (both sample at pixel
  positions; sums in another order);
- the plain K2 (ops/warp.flow_warp) against jax.vjp of
  e2fgvi_tpu/ops/warp.flow_warp, in x and the flow: 1e-4 (the JAX warp
  normalizes its grid in float32, ~1e-6 px);
- K3's plain form (kernels/focal_attention.focal_attention_plain) against
  jax.vjp of e2fgvi_tpu/models/tfocal._attention_xla, in q, k and v: 1e-5;
- window_stage against jax.vjp of the JAX window_stage, in every
  parameter, the features and both flows: 1e-3 relative norm each (an
  8-block transformer and 4 propagation steps in float32; the tanh output
  and its cotangent are O(1)); 5e-4 absolute on the one-element pool
  biases, whose gradients cancel to ~1e-3; 2e-2 on the flows and the
  offset heads, whose gradients jump where a sample position lies within
  float32 rounding of a pixel boundary (<= 8.2e-3 at 60x108). The HQ model on 30x54 features in tier-1
  (~40 s); the base model at test_torch_generator.py's shape (60x108, b=1)
  in the slow tier (the JAX vjp alone takes ~130 s eagerly);
- the port's remat: every gradient equal with it on and off.

These are the backward passes the card recomputes: each kernel's autograd
Function returns its plain version's vector-Jacobian product."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.convert.torch_loader import convert_generator
from e2fgvi_tpu.models import e2fgvi as jgen
from e2fgvi_tpu.models import tfocal as jtf
from e2fgvi_tpu.ops.dcn import modulated_deform_conv2d as jdcn
from e2fgvi_tpu.ops.warp import flow_warp as jwarp
from e2fgvi_tpu_torch.convert.from_jax import from_jax_params
from e2fgvi_tpu_torch.kernels import deform
from e2fgvi_tpu_torch.kernels.focal_attention import focal_attention_plain
from e2fgvi_tpu_torch.models import e2fgvi as tgen
from test_generator_golden import fill_weight

torch.set_num_threads(2)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in arrays]


def test_k1_plain_gradients_match_jax_vjp(rng):
    n, h, w, g, k, cin, cout = 2, 10, 13, 4, 9, 16, 8
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    off = rng.uniform(-6, 6, (n, h, w, g, k, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, g, k)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ct = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    _, vjp = jax.vjp(jdcn, *(jnp.asarray(a) for a in (x, off, mask, wgt, b)))
    want = [np.asarray(gr) for gr in vjp(jnp.asarray(ct))]
    want[3] = want[3].transpose(3, 2, 0, 1)                 # HWIO -> OIHW
    ins = _leaves(x, off, mask, wgt.transpose(3, 2, 0, 1), b)
    out = deform.modulated_deform_conv2d(*ins)
    out.backward(torch.from_numpy(ct))
    for name, t, wg in zip(("x", "offset", "mask", "weight", "bias"), ins,
                           want):
        assert _rel_norm(t.grad.numpy(), wg) < 1e-5, name


def test_k2_plain_gradients_match_jax_vjp(rng):
    n, h, w, c = 2, 9, 14, 6
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-1, 1, (n, h, w, 2)).astype(np.float32)
    flow[..., 0] *= 6.0
    flow[..., 1] *= 4.0
    ct = rng.standard_normal((n, h, w, c)).astype(np.float32)
    _, vjp = jax.vjp(jwarp, jnp.asarray(x), jnp.asarray(flow))
    want = [np.asarray(gr) for gr in vjp(jnp.asarray(ct))]
    ins = _leaves(x, flow)
    deform.flow_warp(*ins).backward(torch.from_numpy(ct))
    for name, t, wg in zip(("x", "flow"), ins, want):
        assert _rel_norm(t.grad.numpy(), wg) < 1e-4, name


def test_k3_plain_gradients_match_jax_vjp(rng):
    """Per-key bias with the -100 pooled-boundary and -1e9 padding values
    the model uses."""
    b, heads, nwin, nq, nk, hd = 2, 2, 3, 10, 25, 16
    q = (rng.standard_normal((b * nwin, heads, nq, hd)) * 0.3).astype(
        np.float32)
    k = rng.standard_normal((b * nwin, heads, nk, hd)).astype(np.float32)
    v = rng.standard_normal((b * nwin, heads, nk, hd)).astype(np.float32)
    bias = np.where(rng.uniform(0, 1, (b * nwin, nk)) < 0.2, -100.0,
                    np.log(rng.integers(1, 4, (b * nwin, nk)))).astype(
        np.float32)
    bias[-1, -5:] = -1e9
    ct = rng.standard_normal((b * nwin, heads, nq, hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: jtf._attention_xla(
        q_, k_, v_, jnp.asarray(bias), b), *(jnp.asarray(a) for a in
                                             (q, k, v)))
    want = [np.asarray(gr) for gr in vjp(jnp.asarray(ct))]

    def port_layout(a):   # (b*nwin, heads, n, hd) -> (b*heads*nwin, n, hd)
        return a.reshape(b, nwin, heads, -1, hd).transpose(0, 2, 1, 3, 4) \
            .reshape(b * heads * nwin, -1, hd)

    ins = _leaves(port_layout(q), port_layout(k), port_layout(v))
    out = focal_attention_plain(*ins, torch.from_numpy(bias), b, heads)
    out.backward(torch.from_numpy(
        ct.transpose(0, 2, 1, 3).reshape(b * nwin, nq, heads * hd).copy()))
    for name, t, wg in zip("qkv", ins, want):
        assert _rel_norm(t.grad.numpy(), port_layout(wg)) < 1e-5, name


def _reference_sd(variant):
    data = np.load(os.path.join(GOLDENS, f"generator_{variant}.npz"))
    keys = [str(k) for k in data["keys"]]
    shapes = [ast.literal_eval(str(s)) for s in data["shapes"]]
    rng = np.random.default_rng(7)
    return {k: fill_weight(k, s, rng) for k, s in zip(keys, shapes)}


def _window_inputs(h, w):
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((1, 4, h, w, 128)).astype(np.float32)
    ff = (rng.standard_normal((1, 2, h, w, 2)) * 1.5).astype(np.float32)
    fb = (rng.standard_normal((1, 2, h, w, 2)) * 1.5).astype(np.float32)
    ct = rng.standard_normal((1, 3, 4 * h, 4 * w, 3)).astype(np.float32)
    return feat, ff, fb, ct


def _port_window_grads(model, feat, ff, fb, ct, remat):
    model.zero_grad(set_to_none=True)
    ins = _leaves(feat, ff, fb)
    out = tgen.window_stage(model, ins[0], (ins[1], ins[2]), 3, num_out=3,
                            remat=remat)
    out.backward(torch.from_numpy(ct))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return grads, [t.grad for t in ins]


@pytest.mark.parametrize("variant,size", [
    ("hq", (30, 54)),
    pytest.param("base", (60, 108), marks=pytest.mark.slow)])
def test_window_stage_gradients_match_jax_vjp(variant, size):
    """Full width, b=1, L=3 locals + 1 ref, the three local frames
    decoded; remat on (the training default), then the gradients again
    with it off."""
    reference_sd = _reference_sd(variant)
    feat, ff, fb, ct = _window_inputs(*size)
    params = convert_generator(reference_sd, variant)
    _, vjp = jax.vjp(
        lambda p, x, a, b: jgen.window_stage(p, x, (a, b), 3, num_out=3),
        params, jnp.asarray(feat), jnp.asarray(ff), jnp.asarray(fb))
    gp, gfeat, gff, gfb = vjp(jnp.asarray(ct))
    want = from_jax_params(jax.tree.map(np.asarray, gp), variant)

    model = tgen.Generator(variant)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in reference_sd.items()}, strict=True)
    grads, (dfeat, dff, dfb) = _port_window_grads(model, feat, ff, fb, ct,
                                                  remat=True)
    # window_stage reaches every parameter but the encoder's and SPyNet's
    assert len(grads) > 100
    assert not any(k.startswith(("encoder.", "update_spynet."))
                   for k in grads)
    errs = {k: _rel_norm(g.numpy(), want[k].numpy())
            for k, g in grads.items()}
    # one-element tensors (the pool biases): their gradient is a sum over
    # every pooled token and channel that cancels to ~1e-3, so float32
    # rounding is held in absolute terms (they read <= 1.3e-5 at 30x54,
    # <= 1.9e-4 at 60x108)
    scalars = {k: float((g - want[k]).abs().max()) for k, g in grads.items()
               if g.numel() == 1}
    assert max(scalars.values()) < 5e-4, scalars
    errs = {k: v for k, v in errs.items() if k not in scalars}
    errs["feat"] = _rel_norm(dfeat.numpy(), gfeat)
    errs["flows_forward"] = _rel_norm(dff.numpy(), gff)
    errs["flows_backward"] = _rel_norm(dfb.numpy(), gfb)
    # the gradients of the sample positions - the flows' and the offset
    # heads' (conv_offset) - are the samplers' slopes: where a position
    # lies within float32 rounding of a pixel boundary (the JAX warp
    # normalizes its grid, the port does not), the two packages take the
    # slopes of neighbouring cells (at 60x108, ten of the 25920 flow
    # elements carry ~90% of the squared difference)
    over = {k: v for k, v in errs.items()
            if v >= (2e-2 if "flows" in k or "conv_offset" in k else 1e-3)}
    assert not over, over

    grads_off, ins_off = _port_window_grads(model, feat, ff, fb, ct,
                                            remat=False)
    assert grads_off.keys() == grads.keys()
    for k, g in grads.items():
        torch.testing.assert_close(grads_off[k], g, rtol=0, atol=0)
    for a, b in zip(ins_off, (dfeat, dff, dfb)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
