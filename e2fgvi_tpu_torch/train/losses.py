"""Training losses: adversarial (nsgan, lsgan, hinge), hole/valid L1, flow.

Counterpart of e2fgvi_tpu/train/losses.py (reference core/loss.py
AdversarialLoss, the loss assembly of core/trainer.py:293-360 and the
flow-completion loss of model/modules/flow_comp.py:11-46).
"""

import torch

from e2fgvi_tpu_torch.models.e2fgvi import forward_bidirect_flow


def adversarial_loss(outputs, is_real: bool, is_disc: bool,
                     gan_type: str = "hinge"):
    """The reference core/loss.py:29-41 semantics."""
    if gan_type == "hinge":
        if is_disc:
            o = -outputs if is_real else outputs
            return torch.relu(1.0 + o).mean()
        return (-outputs).mean()
    target = torch.full_like(outputs, 1.0 if is_real else 0.0)
    if gan_type == "nsgan":
        return -(target * torch.log(outputs + 1e-8)
                 + (1 - target) * torch.log(1 - outputs + 1e-8)).mean()
    if gan_type == "lsgan":
        return ((outputs - target) ** 2).mean()
    raise ValueError(gan_type)


def l1(a, b):
    return (a - b).abs().mean()


def hole_valid_losses(pred_imgs, frames, masks):
    """Mask-normalized L1 losses (reference core/trainer.py:347-360).
    pred_imgs, frames: (B, T, H, W, 3); masks: (B, T, H, W, 1)."""
    hole = l1(pred_imgs * masks, frames * masks) / masks.mean()
    valid = l1(pred_imgs * (1 - masks), frames * (1 - masks)) \
        / (1 - masks).mean()
    return hole, valid


def flow_completion_loss(fixed_spynet, pred_flows, gt_local_frames):
    """L1 between the predicted flows (the trainable SPyNet on masked
    frames) and the flows of a frozen SPyNet on the unmasked local frames
    in [0, 1], taken without gradient (reference flow_comp.py:21-46)."""
    with torch.no_grad():
        gt = forward_bidirect_flow(fixed_spynet, gt_local_frames)
    return l1(pred_flows[0], gt[0]) + l1(pred_flows[1], gt[1])
