"""Temporal PatchGAN discriminator (3-D convs + spectral norm), channel-last.

Counterpart of e2fgvi_tpu/models/discriminator.py (reference
model/e2fgvi.py:271-344 and its vendored spectral norm,
model/modules/spectral_norm.py):

- 6 conv3d stages, kernel (3, 5, 5), stride (1, 2, 2); the first conv pads
  1 on every dim while the rest pad (1, 2, 2) (the reference's quirk,
  e2fgvi.py:287/296, kept for checkpoint-shape compatibility);
  LeakyReLU(0.2) between stages; the last conv is not spectral-normalized
  and carries a bias.
- Spectral norm is written out with an explicit power-iteration vector `u`
  per normalized conv, a buffer `u{i}`: one power iteration a call when
  update=True, u and v taken without gradient, sigma = u . (W v), as
  e2fgvi_tpu/models/discriminator.py:38-55 computes it (not
  torch.nn.utils.spectral_norm, whose update order is its own). A call
  with update=True replaces the buffer with the new u (a new tensor, never
  written in place, so a graph that used the old one keeps it); the train
  step threads it real -> fake -> the generator's adversarial term, as the
  JAX step does.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

NF = 32
# (cin, cout, padding, spectral norm)
STAGES = [
    (3, NF, (1, 1, 1), True),
    (NF, NF * 2, (1, 2, 2), True),
    (NF * 2, NF * 4, (1, 2, 2), True),
    (NF * 4, NF * 4, (1, 2, 2), True),
    (NF * 4, NF * 4, (1, 2, 2), True),
    (NF * 4, NF * 4, (1, 2, 2), False),
]
KERNEL, STRIDE = (3, 5, 5), (1, 2, 2)
EPS = 1e-12


def l2normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=EPS)


def spectral_normalize(w, u, update: bool):
    """One power iteration on a conv weight w (Cout, ...) with the left
    singular vector estimate u (Cout,). Returns (w / sigma, u), u the new
    estimate where update is True."""
    mat = w.reshape(w.shape[0], -1)
    if update:
        with torch.no_grad():
            v = l2normalize(mat.t() @ u)
            u = l2normalize(mat @ v)
    else:
        v = l2normalize(mat.t() @ u)
    sigma = u @ (mat @ v)
    return w / sigma, u


class Discriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv3d(cin, cout, KERNEL, STRIDE, pad, bias=not sn)
            for cin, cout, pad, sn in STAGES)
        for i, (_, cout, _, sn) in enumerate(STAGES):
            if sn:
                self.register_buffer(f"u{i}", torch.zeros(cout))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """N(0, 0.02) weights, a zero last bias, random unit u (the JAX
        package's distributions)."""
        for i, (conv, (_, cout, _, sn)) in enumerate(zip(self.convs, STAGES)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * 0.02)
            if sn:
                setattr(self, f"u{i}",
                        l2normalize(torch.randn(cout, generator=gen)))
            else:
                conv.bias.zero_()
        return self

    def forward(self, xs, update: bool = False, use_sigmoid: bool = False):
        """xs: (B, T, H, W, 3) clip -> (B, T, H/64, W/64, 128) patch logits
        (T kept: stride 1 in time). update: one power iteration of every
        spectral norm, its u kept."""
        x = xs.permute(0, 4, 1, 2, 3)
        for i, (conv, (_, _, pad, sn)) in enumerate(zip(self.convs, STAGES)):
            w = conv.weight
            if sn:
                w, u = spectral_normalize(w, getattr(self, f"u{i}"), update)
                if update:
                    setattr(self, f"u{i}", u)
            x = F.conv3d(x, w, conv.bias, stride=STRIDE, padding=pad)
            if i < len(STAGES) - 1:
                x = F.leaky_relu(x, 0.2)
        if use_sigmoid:
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 4, 1)
