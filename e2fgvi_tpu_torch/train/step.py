"""The GAN training step: one generator forward and backward, one
discriminator update.

Counterpart of e2fgvi_tpu/train/step.py (reference core/trainer.py:293-366),
in the JAX step's order (step.py:65-158):

1. the generator forward, its graph kept;
2. the discriminator's hinge (or nsgan / lsgan) update on the real clip and
   on the detached composite, the spectral-norm vectors threaded
   real -> fake;
3. the generator's losses: adversarial against the *updated*
   discriminator (whose power iteration is kept, as the JAX step keeps
   pd3's u), flow completion against a frozen SPyNet, hole/valid L1;
4. the generator's backward and update.

Optimizers: Adam(betas=(beta1, beta2) = (0, 0.99), eps=1e-8) for both, the
generator's SPyNet subtree its own param group at lr x spynet_lr
(step.py:40-62). Before each optimizer step the lr is set from the
schedule at the iteration count before the increment, where optax's
scale_by_schedule reads it. The adversarial term reaches the generator
only: the discriminator's parameters take no gradient from it, so none
reaches the discriminator's next update.
"""

import copy

import torch

from e2fgvi_tpu_torch.train import losses


class TrainState:
    """The models, optimizers and iteration of a training run. gen_call and
    dis_call are what the step calls (DistributedDataParallel wrappers
    where training runs in several processes, else the modules)."""

    def __init__(self, gen, dis, lr_fn, spynet_lr=1.0, beta1=0.0,
                 beta2=0.99):
        self.gen, self.dis = gen, dis
        self.gen_call, self.dis_call = gen, dis
        # the flow loss's SPyNet: a frozen copy of the trainable one
        self.fixed_spynet = copy.deepcopy(gen.update_spynet).requires_grad_(
            False)
        self.lr_fn = lr_fn
        spy = [p for n, p in gen.named_parameters()
               if n.startswith("update_spynet.")]
        rest = [p for n, p in gen.named_parameters()
                if not n.startswith("update_spynet.")]
        adam = dict(lr=lr_fn(0), betas=(beta1, beta2), eps=1e-8)
        self.opt_g = torch.optim.Adam(
            [{"params": rest, "lr_mult": 1.0},
             {"params": spy, "lr_mult": float(spynet_lr)}], **adam)
        self.opt_d = torch.optim.Adam(
            [{"params": list(dis.parameters()), "lr_mult": 1.0}], **adam)
        self.step = 0


def _optimizer_step(opt, lr):
    for group in opt.param_groups:
        group["lr"] = lr * group["lr_mult"]
    opt.step()


def make_train_step(num_local_frames, config_losses, no_dis=False,
                    gan_type="hinge"):
    """step(state, frames, masks) -> logs. frames: (B, T, H, W, 3) in
    [-1, 1]; masks: (B, T, H, W, 1), 1 = hole; on the models' device.
    The generator recomputes each propagation step and transformer block
    in the backward pass (remat, the JAX step's default)."""
    hole_w = config_losses.get("hole_weight", 1.0)
    valid_w = config_losses.get("valid_weight", 1.0)
    flow_w = config_losses.get("flow_weight", 1.0)
    adv_w = config_losses.get("adversarial_weight", 0.01)
    sigmoid = gan_type != "hinge"
    lt = num_local_frames

    def step(state: TrainState, frames, masks):
        b, t, h, w, _ = frames.shape
        lr = state.lr_fn(state.step)
        masked = frames * (1.0 - masks)
        gt_local = (frames[:, :lt] + 1.0) / 2.0

        # 1. generator forward, graph kept
        pred, flows = state.gen_call(masked, lt, remat=True)
        pred = pred.reshape(b, t, h, w, 3)
        comp = frames * (1.0 - masks) + masks * pred
        logs = {}

        if not no_dis:
            # 2. discriminator update on real and the detached composite
            state.opt_d.zero_grad(set_to_none=True)
            real = state.dis_call(frames, update=True, use_sigmoid=sigmoid)
            fake = state.dis_call(comp.detach(), update=True,
                                  use_sigmoid=sigmoid)
            d_real = losses.adversarial_loss(real, True, True, gan_type)
            d_fake = losses.adversarial_loss(fake, False, True, gan_type)
            d_loss = (d_real + d_fake) / 2.0
            d_loss.backward()
            _optimizer_step(state.opt_d, lr)
            logs.update(dis_loss=d_loss, dis_real=d_real, dis_fake=d_fake)

        # 3. generator losses, against the updated discriminator
        gen_loss = 0.0
        if not no_dis:
            state.dis.requires_grad_(False)
            try:
                logits = state.dis(comp, update=True, use_sigmoid=sigmoid)
            finally:
                state.dis.requires_grad_(True)
            gan_loss = adv_w * losses.adversarial_loss(logits, True, False,
                                                       gan_type)
            gen_loss = gen_loss + gan_loss
            logs["gan_loss"] = gan_loss
        flow_loss = flow_w * losses.flow_completion_loss(
            state.fixed_spynet, flows, gt_local)
        hole, valid = losses.hole_valid_losses(pred, frames, masks)
        gen_loss = gen_loss + flow_loss + hole_w * hole + valid_w * valid

        # 4. generator backward and update
        state.opt_g.zero_grad(set_to_none=True)
        gen_loss.backward()
        _optimizer_step(state.opt_g, lr)
        state.step += 1
        logs.update(gen_loss=gen_loss, flow_loss=flow_loss,
                    hole_loss=hole_w * hole, valid_loss=valid_w * valid)
        return {k: v.detach() for k, v in logs.items()}

    return step
