"""The port's training utilities against the JAX package's, on seeded
numpy inputs: the LR schedules (e2fgvi_tpu_torch/train/schedules.py) at
steps 0 to 5e5 including restarts, rtol 1e-6 and atol 1e-11 (the JAX
schedules run in float32: 1e-7 of the base lr); the three GAN losses and
the hole/valid L1 (train/losses.py), rtol 1e-5 (float32 means summed in
another order); the flow-completion loss through the frozen SPyNet, rtol 1e-5
(SPyNet's convolutions sum in another order); the TensorBoard writer
(utils/tb.py), byte-equal to the JAX package's writer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.models import spynet as jspynet
from e2fgvi_tpu.train import losses as jlosses
from e2fgvi_tpu.train import schedules as jsched
from e2fgvi_tpu.utils import tb as jtb
from e2fgvi_tpu_torch.convert.from_jax import spynet_state, to_torch
from e2fgvi_tpu_torch.models.spynet import SPyNet
from e2fgvi_tpu_torch.train import losses, schedules
from e2fgvi_tpu_torch.utils import tb

torch.set_num_threads(2)

# milestones, restarts and periods inside 0..5e5, the reference's range
_STEPS = sorted(set(range(0, 500_001, 2500)) | {
    s + d for s in (100_000, 150_000, 200_000, 300_000, 400_000, 500_000)
    for d in (-1, 0, 1)})
_SCHEDULES = {
    "multistep": ({"type": "MultiStepLR", "milestones": [400_000],
                   "gamma": 0.1}, None),
    "multistep_restart": (None, dict(milestones=[150_000, 400_000],
                                     gamma=0.5, restarts=(0, 200_000),
                                     restart_weights=(1.0, 0.5))),
    "cosine_restart": ({"type": "CosineAnnealingRestartLR",
                        "periods": [100_000, 200_000, 200_000],
                        "restart_weights": [1.0, 0.5, 0.25]}, None),
}


@pytest.mark.parametrize("name", list(_SCHEDULES))
def test_schedules_match_jax(name):
    cfg, restart = _SCHEDULES[name]
    if cfg is not None:
        mine = schedules.make_schedule(cfg, 1e-4)
        want = jsched.make_schedule(cfg, 1e-4)
    else:
        mine = schedules.multistep_restart_lr(1e-4, **restart)
        want = jsched.multistep_restart_lr(1e-4, **restart)
    got = np.array([mine(s) for s in _STEPS])
    ref = np.array([float(want(s)) for s in _STEPS])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-11)
    assert len(set(np.round(got / 1e-4, 6))) > 1     # the schedule moves


@pytest.mark.parametrize("gan_type", ["hinge", "nsgan", "lsgan"])
def test_adversarial_losses_match_jax(gan_type, rng):
    x = rng.standard_normal((2, 3, 4, 5, 8)).astype(np.float32)
    if gan_type != "hinge":
        x = 1.0 / (1.0 + np.exp(-x))              # sigmoid outputs
    for is_real in (True, False):
        for is_disc in (True, False):
            got = losses.adversarial_loss(torch.from_numpy(x), is_real,
                                          is_disc, gan_type)
            want = jlosses.adversarial_loss(jnp.asarray(x), is_real,
                                            is_disc, gan_type)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_hole_valid_losses_match_jax(rng):
    pred = rng.uniform(-1, 1, (2, 4, 12, 20, 3)).astype(np.float32)
    frames = rng.uniform(-1, 1, (2, 4, 12, 20, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (2, 4, 12, 20, 1)) > 0.6).astype(np.float32)
    got = losses.hole_valid_losses(*(torch.from_numpy(a)
                                     for a in (pred, frames, masks)))
    want = jlosses.hole_valid_losses(*(jnp.asarray(a)
                                       for a in (pred, frames, masks)))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-5)


def test_flow_completion_loss_matches_jax(rng):
    """The frozen SPyNet's flows on unmasked frames against predicted
    flows; the port's SPyNet carries the JAX SPyNet's weights."""
    import jax
    params = jspynet.init_params(jax.random.PRNGKey(3))
    net = SPyNet()
    net.load_state_dict(to_torch(spynet_state(
        jax.tree.map(np.asarray, params), prefix="")), strict=True)
    frames = rng.uniform(0, 1, (1, 3, 64, 96, 3)).astype(np.float32)
    pred = [(rng.standard_normal((1, 2, 16, 24, 2)) * 0.5).astype(np.float32)
            for _ in range(2)]
    got = losses.flow_completion_loss(
        net, [torch.from_numpy(p) for p in pred], torch.from_numpy(frames))
    want = jlosses.flow_completion_loss(
        params, [jnp.asarray(p) for p in pred], jnp.asarray(frames))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_tb_writer_bytes_equal_the_jax_writer(tmp_path, monkeypatch):
    """The same scalars at a fixed clock: the two event files are equal
    byte for byte (record framing, masked CRC32C, protobuf fields)."""
    for mod in (tb, jtb):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    files = []
    for mod, sub in ((tb, "port"), (jtb, "jax")):
        w = mod.SummaryWriter(str(tmp_path / sub))
        for i in range(5):
            w.add_scalar("loss/gen", 1.0 / (i + 1), 100 * i)
        w.add_scalar("loss/dis_fake", -0.5, 1000)
        w.close()
        (f,) = list((tmp_path / sub).iterdir())
        files.append(f.read_bytes())
    assert files[0] == files[1]
    assert len(files[0]) > 200 and b"loss/dis_fake" in files[0]
