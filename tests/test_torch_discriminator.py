"""The port's discriminator (e2fgvi_tpu_torch/models/discriminator.py)
against the JAX package's on carried weights (convert/from_jax.py
discriminator_state): logits and the spectral-norm vectors u over three
threaded calls, rtol 1e-4 / atol 1e-6 on logits and 1e-5 on u (3-D
convolutions and power iterations summed in another order), the eval-mode
logits, and one discriminator update of the train step's form
(e2fgvi_tpu/train/step.py d_loss_fn: real, then the fake with the real
call's u) against jax.value_and_grad: the loss within 1e-5 relative, each
weight's gradient within 1e-4 relative norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.models import discriminator as jdisc
from e2fgvi_tpu.train import losses as jlosses
from e2fgvi_tpu_torch.convert.from_jax import discriminator_state
from e2fgvi_tpu_torch.models import discriminator as disc
from e2fgvi_tpu_torch.train import losses

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def carried():
    params = jdisc.init_params(jax.random.PRNGKey(1))
    model = disc.Discriminator()
    model.load_state_dict(discriminator_state(
        jax.tree.map(np.asarray, params)), strict=True)
    return params, model


def _clips(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (2, 4, 64, 96, 3)).astype(np.float32)
            for _ in range(n)]


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_logits_and_u_over_three_threaded_calls(carried):
    params, model = carried
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    p = params
    for x in _clips(2, 3):
        want, p = jdisc.apply(p, jnp.asarray(x), update_stats=True)
        with torch.no_grad():
            got = model(torch.from_numpy(x), update=True)
        assert got.shape == want.shape and got.shape[1] == 4
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
        for i in range(5):
            np.testing.assert_allclose(getattr(model, f"u{i}").numpy(),
                                       np.asarray(p["u"][i]), rtol=1e-5,
                                       atol=1e-6)
    # eval mode: u stays, the logits are the JAX update_stats=False ones
    x = _clips(5, 1)[0]
    want, _ = jdisc.apply(p, jnp.asarray(x), update_stats=False)
    u_before = [getattr(model, f"u{i}") for i in range(5)]
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert all(getattr(model, f"u{i}") is u for i, u in enumerate(u_before))
    model.load_state_dict(sd0)


@pytest.mark.parametrize("gan_type", ["hinge", "lsgan"])
def test_one_discriminator_update_matches_jax(carried, gan_type):
    params, model = carried
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    real, fake = _clips(3)
    sig = gan_type != "hinge"

    def d_loss_fn(pd):
        r, pd1 = jdisc.apply(pd, jnp.asarray(real), update_stats=True,
                             use_sigmoid=sig)
        f, pd2 = jdisc.apply({"convs": pd["convs"], "u": pd1["u"]},
                             jnp.asarray(fake), update_stats=True,
                             use_sigmoid=sig)
        loss = (jlosses.adversarial_loss(r, True, True, gan_type)
                + jlosses.adversarial_loss(f, False, True, gan_type)) / 2.0
        return loss, pd2["u"]

    (want_loss, want_u), grads = jax.value_and_grad(
        d_loss_fn, has_aux=True)(params)

    model.zero_grad(set_to_none=True)
    r = model(torch.from_numpy(real), update=True, use_sigmoid=sig)
    f = model(torch.from_numpy(fake), update=True, use_sigmoid=sig)
    loss = (losses.adversarial_loss(r, True, True, gan_type)
            + losses.adversarial_loss(f, False, True, gan_type)) / 2.0
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for i in range(5):
        np.testing.assert_allclose(getattr(model, f"u{i}").numpy(),
                                   np.asarray(want_u[i]), rtol=1e-5,
                                   atol=1e-6)
    want_g = discriminator_state(jax.tree.map(np.asarray, grads))
    for name, prm in model.named_parameters():
        err = _rel_norm(prm.grad.numpy(), want_g[name].numpy())
        assert err < 1e-4, (name, err)
    model.load_state_dict(sd0)
