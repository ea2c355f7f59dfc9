"""One port train step (e2fgvi_tpu_torch/train/step.py) against the JAX
package's make_train_step, from one carried state (convert/from_jax.py
from_jax_train_state), at tests/test_train_step.py's geometry: the base
model at full width on 60x108 frames, 5 local + 1 reference frames, with
the discriminator (b=2) and in no_dis mode (b=1).

Compared: every logged loss within 1e-4 relative, and the gradient g of
every parameter of the generator and of the discriminator:
||g - g_jax|| <= 2e-3 ||g_jax|| + 1e-7 sqrt(numel) (float32 through
SPyNet, 8 transformer blocks and the propagation; the port samples at
pixel positions where the JAX warp normalizes its grid; the floor holds
gradients that cancel to ~1e-7, as the mean-initialized pool layers'
do). Not the updated parameters: Adam with beta1 = 0
moves every weight by about +-lr on the first step, so the sign of a
near-zero gradient decides a parameter. The JAX gradients come from the
step's own code path (jax.vjp of generator_forward, d_loss_fn, g_loss_fn,
as step.py:65-158 runs them), whose losses are first held to
make_train_step's logs. The JAX side runs eagerly on the CPU: several
minutes, so the slow tier, next to tests/test_train_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.models import discriminator as jdisc
from e2fgvi_tpu.models import e2fgvi as jgen
from e2fgvi_tpu.train import losses as jlosses
from e2fgvi_tpu.train import step as jstep
from e2fgvi_tpu_torch.convert.from_jax import from_jax_train_state
from e2fgvi_tpu_torch.models import discriminator, e2fgvi, tfocal
from e2fgvi_tpu_torch.train import step as step_lib

torch.set_num_threads(4)
LOSSES = {"hole_weight": 1, "valid_weight": 1, "flow_weight": 1,
          "adversarial_weight": 0.01}
LR = 1e-4


@pytest.fixture(scope="module")
def jax_state():
    params_g = jgen.init_params(jax.random.PRNGKey(0), variant="base")
    params_g["sc"]["bias"] = jnp.zeros((15, 27, 128), jnp.float32)
    params_d = jdisc.init_params(jax.random.PRNGKey(1))
    tx_g, tx_d = jstep.make_optimizers(LR, lambda s: LR, spynet_lr_mult=0.5)
    state = jstep.init_train_state(params_g, params_d, params_g["spynet"],
                                   tx_g, tx_d)
    return state, tx_g, tx_d


def _batch(b):
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (b, 6, 60, 108, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (b, 6, 60, 108, 1)) > 0.7).astype(np.float32)
    return frames, masks


def _jax_grads(state, tx_d, frames, masks, no_dis):
    """The JAX step's losses and gradients, by its own code path."""
    lt = 5
    b, t, h, w, _ = frames.shape
    frames, masks = jnp.asarray(frames), jnp.asarray(masks)
    masked = frames * (1.0 - masks)
    gt_local = (frames[:, :lt] + 1.0) / 2.0

    def g_fwd(pg):
        pred, flows = jgen.generator_forward(pg, masked, lt)
        return pred.reshape(b, t, h, w, 3), flows

    (pred, flows), g_vjp = jax.vjp(g_fwd, state.params_g)
    logs, d_grads, params_d = {}, None, state.params_d
    if not no_dis:
        comp_sg = jax.lax.stop_gradient(frames * (1.0 - masks)
                                        + masks * pred)

        def d_loss_fn(pd):
            real, pd1 = jdisc.apply(pd, frames, update_stats=True)
            fake, pd2 = jdisc.apply({"convs": pd["convs"], "u": pd1["u"]},
                                    comp_sg, update_stats=True)
            d_real = jlosses.adversarial_loss(real, True, True)
            d_fake = jlosses.adversarial_loss(fake, False, True)
            return (d_real + d_fake) / 2.0, (pd2["u"], d_real, d_fake)

        (d_loss, (new_u, d_real, d_fake)), d_grads = jax.value_and_grad(
            d_loss_fn, has_aux=True)(params_d)
        upd, _ = tx_d.update(d_grads, state.opt_d, params_d)
        params_d = jax.tree.map(lambda p, u: p + u, params_d, upd)
        params_d = {"convs": params_d["convs"], "u": new_u}
        logs.update(dis_loss=d_loss, dis_real=d_real, dis_fake=d_fake)

    def g_loss_fn(pred, flows):
        loss, aux = 0.0, {}
        if not no_dis:
            comp = frames * (1.0 - masks) + masks * pred
            logits, _ = jdisc.apply(params_d, comp, update_stats=True)
            aux["gan_loss"] = LOSSES["adversarial_weight"] * \
                jlosses.adversarial_loss(logits, True, False)
            loss += aux["gan_loss"]
        aux["flow_loss"] = jlosses.flow_completion_loss(
            state.fixed_spynet, flows, gt_local)
        hole, valid = jlosses.hole_valid_losses(pred, frames, masks)
        aux.update(hole_loss=hole, valid_loss=valid)
        return loss + aux["flow_loss"] + hole + valid, aux

    (g_loss, aux), cts = jax.value_and_grad(
        g_loss_fn, argnums=(0, 1), has_aux=True)(pred, flows)
    (g_grads,) = g_vjp(cts)
    logs.update(gen_loss=g_loss, **aux)
    return ({k: float(v) for k, v in logs.items()}, g_grads, d_grads)


def _port_state(state):
    carried = from_jax_train_state(jax.tree.map(np.asarray, state))
    gen = e2fgvi.Generator("base")
    gen.sc = tfocal.SoftComp(128, 512, (15, 27))
    gen.load_state_dict(carried["gen"], strict=True)
    dis = discriminator.Discriminator()
    dis.load_state_dict(carried["dis"], strict=True)
    st = step_lib.TrainState(gen, dis, lambda s: LR, spynet_lr=0.5)
    st.fixed_spynet.load_state_dict(carried["fixed_spynet"], strict=True)
    st.step = carried["step"]
    return st


def _check_grads(module, want, rel=2e-3, floor=1e-7):
    """Each gradient within rel of its JAX norm plus floor per element."""
    over = {}
    for k, p in module.named_parameters():
        g, w = p.grad.double().numpy(), want[k].double().numpy()
        err = float(np.linalg.norm(g - w))
        bound = rel * float(np.linalg.norm(w)) + floor * np.sqrt(w.size)
        if not err <= bound:
            over[k] = (err, bound)
    assert not over, over


@pytest.mark.slow
@pytest.mark.parametrize("no_dis", [False, True])
def test_port_step_matches_jax_step(jax_state, no_dis):
    state, tx_g, tx_d = jax_state
    frames, masks = _batch(1 if no_dis else 2)
    want_logs, g_grads, d_grads = _jax_grads(state, tx_d, frames, masks,
                                             no_dis)
    if not no_dis:
        # the replicated path is make_train_step's
        _, logs = jstep.make_train_step(tx_g, tx_d, 5, LOSSES,
                                        remat=False)(state, frames, masks)
        for k, v in logs.items():
            np.testing.assert_allclose(want_logs[k], float(v), rtol=1e-6,
                                       err_msg=k)

    st = _port_state(state)
    step = step_lib.make_train_step(5, LOSSES, no_dis=no_dis)
    logs = step(st, torch.from_numpy(frames), torch.from_numpy(masks))
    assert st.step == 1 and sorted(logs) == sorted(want_logs)
    for k, v in logs.items():
        np.testing.assert_allclose(float(v), want_logs[k], rtol=1e-4,
                                   err_msg=k)
    carried = from_jax_train_state(state._replace(
        params_g=jax.tree.map(np.asarray, g_grads),
        params_d=jax.tree.map(np.asarray, d_grads if d_grads is not None
                              else state.params_d)))
    _check_grads(st.gen, carried["gen"])
    if not no_dis:
        _check_grads(st.dis, carried["dis"])
    else:
        assert all(p.grad is None for p in st.dis.parameters())
