"""Wan2.1-VACE-1.3B masked video-to-video inpainting (VACE, Jiang et al.,
ICCV 2025; ali-vilab/VACE vace/models/wan/wan_vace.py: WanVace.generate,
vace_encode_frames, vace_encode_masks) on Wan2.1's DiT (models/wan_dit.py)
and causal VAE (models/wan_vae.py).

A clip of 1 + 4n frames and its masks become VACE's 96-channel context:
the VAE latents of the frames outside the mask (inactive) and inside it
(reactive), 16 + 16 channels, and the mask folded 8 x 8 into 64 channels
and taken to the latent's frame count by nearest-exact interpolation.
Noise latents drawn from the model's seed are then denoised by `steps`
Euler steps on Wan's shifted flow-matching schedule, each step two DiT
forwards (the prompt's and the negative prompt's) combined by classifier-
free guidance; the VAE decodes the result. The sampler's arithmetic is
float32.

`VaceWan` carries the DiT, the VAE, the sampler's settings and the two
prompt embeddings (umT5's outputs, which this repository does not
compute: a caller sets them, or `seeded_context` stands in for them).
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from e2fgvi_tpu_torch.models.wan_dit import VaceWanModel
from e2fgvi_tpu_torch.models.wan_vae import WanVAE

FAMILY = "wan_vace"
# Wan2.1-VACE-1.3B's published settings; sampler defaults from Wan's
# generate.py (shift 5.0, guidance 5.0, 50 steps)
PUBLISHED = {
    "dit": dict(dim=1536, ffn_dim=8960, freq_dim=256, text_dim=4096,
                text_len=512, in_dim=16, out_dim=16, num_heads=12,
                num_layers=30, patch_size=(1, 2, 2), eps=1e-6,
                vace_layers=tuple(range(0, 30, 2)), vace_in_dim=96),
    "vae": dict(dim=96, z_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=2,
                temperal_downsample=(False, True, True)),
    "steps": 50, "shift": 5.0, "guidance": 5.0,
}
VAE_STRIDE = (4, 8, 8)
NUM_TRAIN_TIMESTEPS = 1000


def schedule(steps, shift, num_train_timesteps=NUM_TRAIN_TIMESTEPS):
    """(timesteps, sigmas) of Wan's flow-matching sampler: `steps` sigmas
    evenly from sigma_max = 1 - 1/N down to 0 (the last dropped), shifted
    to s sigma / (1 + (s - 1) sigma), then a final 0; the model sees each
    sigma times N cast to an integer (int64 numpy, float32 numpy)."""
    sigma_max = float(np.float32(1.0 - 1.0 / num_train_timesteps))
    s = np.linspace(sigma_max, 0.0, steps + 1)[:-1]
    s = shift * s / (1.0 + (shift - 1.0) * s)
    timesteps = (s * num_train_timesteps).astype(np.int64)
    return timesteps, np.append(s, 0.0).astype(np.float32)


def fold_masks(m, frames):
    """(T, H, W) masks -> (64, frames, H/8, W/8): each 8 x 8 cell's pixels
    as channels, then nearest-exact in time (vace_encode_masks)."""
    t, hh, ww = m.shape
    h, w = hh // VAE_STRIDE[1], ww // VAE_STRIDE[2]
    m = m.float().view(t, h, VAE_STRIDE[1], w, VAE_STRIDE[2])
    m = m.permute(2, 4, 0, 1, 3).reshape(VAE_STRIDE[1] * VAE_STRIDE[2],
                                         t, h, w)
    return F.interpolate(m.unsqueeze(0), size=(frames, h, w),
                         mode="nearest-exact")[0]


def vace_context(vae, frames, masks):
    """(96, f, H/8, W/8) context of (T, H, W, 3) uint8 frames and (T, H, W)
    masks on the device: inactive and reactive latents, the folded mask."""
    dt = vae.conv1.weight.dtype
    f = (frames.permute(3, 0, 1, 2).float() / 255.0 * 2.0 - 1.0)
    m = (masks > 0.5).float()
    z = [vae.encode((f * (1.0 - m)).to(dt)), vae.encode((f * m).to(dt))]
    return torch.cat(z + [fold_masks(m, z[0].shape[1])], 0)


def seeded_context(gen, tokens, text_len, text_dim, device):
    """A stand-in for umT5's output of a `tokens`-token prompt: N(0, 1)
    rows from the torch.Generator gen, zero-padded to text_len as Wan
    pads."""
    out = torch.zeros((text_len, text_dim), device=device)
    out[:tokens] = torch.randn((tokens, text_dim), generator=gen,
                               device=device)
    return out


class VaceWan(nn.Module):
    """The DiT with its context blocks, the VAE, and the sampler: steps,
    shift, guidance, the noise seed, and the prompt embeddings `context`
    and `context_null` ((text_len, text_dim), set by the caller)."""

    family = FAMILY

    def __init__(self, dit, vae, steps, shift, guidance, seed=0):
        super().__init__()
        self.dit, self.vae = dit, vae
        self.steps, self.shift, self.guidance = steps, shift, guidance
        self.seed = seed
        self.context = self.context_null = None

    def set_prompts(self, context, context_null):
        """The prompt's and the negative prompt's (text_len, text_dim)
        embeddings, on the model's device in the DiT's dtype."""
        p = self.dit.text_embedding[0].weight
        self.context = context.to(device=p.device, dtype=p.dtype)
        self.context_null = context_null.to(device=p.device, dtype=p.dtype)

    def cast(self, dtype):
        """The DiT (but its float32 parts) and the VAE to dtype."""
        self.dit.cast(dtype)
        self.vae.to(dtype)
        return self

    def sample(self, vace_ctx, timesteps, sigmas, spans, keep_step=None):
        """The denoised (16, f, h, w) float32 latent from the model's seed.
        timesteps: (steps,) float32 on the device; sigmas: host floats.
        spans counts dit_forwards and dit_tokens. keep_step: the step
        whose latent, timestep and guided velocity are returned beside
        (else None)."""
        z = self.vae.z_dim
        f, h, w = vace_ctx.shape[1:]
        gen = torch.Generator(device=vace_ctx.device)
        gen.manual_seed(self.seed)
        x = torch.randn((z, f, h, w), generator=gen, device=vace_ctx.device,
                        dtype=torch.float32)
        tokens = f * h * w // (self.dit.patch_size[1] * self.dit.patch_size[2])
        kept = None
        for i in range(len(sigmas) - 1):
            t = timesteps[i: i + 1]
            v_c = self.dit(x, t, vace_ctx, self.context, spans)
            v_u = self.dit(x, t, vace_ctx, self.context_null, spans)
            spans.count("dit_forwards", 2)
            spans.count("dit_tokens", 2 * tokens)
            v = v_u + self.guidance * (v_c - v_u)
            if i == keep_step:
                kept = {"step": i, "latent": x, "timestep": t, "velocity": v}
            x = x + (float(sigmas[i + 1]) - float(sigmas[i])) * v
        return x, kept


def build(config=None, steps=None):
    """A VaceWan of `config` ({'dit': kwargs, 'vae': kwargs}, optional
    sampler settings; default PUBLISHED), its parameters left as
    constructed; `steps` overrides the config's."""
    config = PUBLISHED if config is None else config
    return VaceWan(VaceWanModel(**config["dit"]), WanVAE(**config["vae"]),
                   steps=steps or config.get("steps", PUBLISHED["steps"]),
                   shift=config.get("shift", PUBLISHED["shift"]),
                   guidance=config.get("guidance", PUBLISHED["guidance"]))


@torch.no_grad()
def init_weights(model, gen):
    """Random init for a smoke run, from the torch.Generator gen on the
    parameters' device: N(0, 1/fan_in) convs and linears (VACE's zero-
    initialised projections and the head included), zero biases, unit
    norms, modulations N(0, 1/dim)."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("modulation"):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    / p.shape[-1] ** 0.5)
        elif p.dim() == 1 or name.endswith("gamma"):
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    / np.prod(p.shape[1:]) ** 0.5)
    return model
