"""Wan2.1's causal 3-D VAE (Wan-Video/Wan2.1 wan/modules/vae.py: WanVAE_,
Encoder3d, Decoder3d), the serving form: it encodes the first frame and
then groups of 4, and decodes one latent frame at a time, each causal
convolution carrying the last two frames of its input from one chunk to
the next (the published frame cache). The module tree has the released
checkpoint's names (Wan2.1_VAE.pth), so its state dict loads as it is.

Shapes are channel-first, (B, C, T, H, W). z_dim 16, dim 96, dim_mult
[1, 2, 4, 4], two residual blocks a stage, temporal downsampling
[False, True, True]: a (3, 1 + 4n, H, W) clip gives a (16, 1 + n, H/8,
W/8) latent, and back.

The cache is a dict owned by one encode or decode call, keyed by module:
a causal convolution's entry is the last two frames of its input so far,
a temporal downsample's the last frame of its input, a temporal
upsample's the fact that it has seen the first chunk (whose frame it
passes through without its time convolution).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

CACHE_T = 2


class CausalConv3d(nn.Conv3d):
    """A Conv3d padded in time only in front (2 * padding frames), so an
    output frame sees its own and earlier input frames; in space as
    given."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        pt, ph, pw = self.padding
        self._pad = (pw, pw, ph, ph, 2 * pt, 0)
        self.padding = (0, 0, 0)

    def forward(self, x, cache=None):
        pad = list(self._pad)
        if cache is not None and pad[4] > 0:
            prev = cache.get(self)
            seq = x if prev is None else torch.cat([prev, x], 2)
            cache[self] = seq[:, :, -CACHE_T:]
            if prev is not None:
                x = seq
                pad[4] -= prev.shape[2]
        return super().forward(F.pad(x, pad))


class RMS_norm(nn.Module):
    """Wan's RMS_norm: x / ||x|| over the channels, times sqrt(C) and a
    per-channel gain (no bias)."""

    def __init__(self, dim, images=True):
        super().__init__()
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(shape))

    def forward(self, x):
        return F.normalize(x, dim=1) * self.scale * self.gamma


class Resample(nn.Module):
    """2x spatial up or down sampling, per frame; the 3-D modes add a
    causal time convolution that doubles (up) or halves (down) the frame
    count after the first frame."""

    def __init__(self, dim, mode):
        super().__init__()
        self.mode = mode
        if mode in ("upsample2d", "upsample3d"):
            self.resample = nn.Sequential(nn.Upsample(scale_factor=(2., 2.),
                                                      mode="nearest-exact"),
                                          nn.Conv2d(dim, dim // 2, 3,
                                                    padding=1))
        else:
            self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)),
                                          nn.Conv2d(dim, dim, 3,
                                                    stride=(2, 2)))
        if mode == "upsample3d":
            self.time_conv = CausalConv3d(dim, dim * 2, (3, 1, 1),
                                          padding=(1, 0, 0))
        elif mode == "downsample3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1),
                                          stride=(2, 1, 1), padding=(0, 0, 0))

    def forward(self, x, cache):
        b, c = x.shape[:2]
        if self.mode == "upsample3d":
            if self in cache:             # the first chunk passes through
                y = self.time_conv(x, cache)
                t = x.shape[2]
                x = y.view(b, 2, c, t, *x.shape[3:]).permute(
                    0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, *x.shape[3:])
            else:
                cache[self] = True
        t = x.shape[2]
        y = x.transpose(1, 2).reshape(b * t, c, *x.shape[3:])
        if self.mode.startswith("upsample"):
            # nearest-exact at 2x repeats each pixel: exact in any dtype
            y = self.resample[1](y.repeat_interleave(2, -2)
                                 .repeat_interleave(2, -1))
        else:
            y = self.resample(y)
        x = y.view(b, t, *y.shape[1:]).transpose(1, 2)
        if self.mode == "downsample3d":
            prev = cache.get(self)
            cache[self] = x[:, :, -1:]
            if prev is not None:
                x = self.time_conv(torch.cat([prev, x], 2))
        return x


class ResidualBlock(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.residual = nn.Sequential(
            RMS_norm(in_dim, images=False), nn.SiLU(),
            CausalConv3d(in_dim, out_dim, 3, padding=1),
            RMS_norm(out_dim, images=False), nn.SiLU(), nn.Dropout(0.0),
            CausalConv3d(out_dim, out_dim, 3, padding=1))
        self.shortcut = (CausalConv3d(in_dim, out_dim, 1)
                         if in_dim != out_dim else nn.Identity())

    def forward(self, x, cache):
        h = self.shortcut(x)
        for layer in self.residual:
            x = (layer(x, cache) if isinstance(layer, CausalConv3d)
                 else layer(x))
        return x + h


class AttentionBlock(nn.Module):
    """Single-head self-attention inside each frame."""

    def __init__(self, dim):
        super().__init__()
        self.norm = RMS_norm(dim)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x, cache=None):
        identity = x
        b, c, t, h, w = x.shape
        y = self.norm(x.transpose(1, 2).reshape(b * t, c, h, w))
        q, k, v = self.to_qkv(y).reshape(b * t, 1, c * 3, h * w).permute(
            0, 1, 3, 2).contiguous().chunk(3, dim=-1)
        y = F.scaled_dot_product_attention(q, k, v)
        y = y.squeeze(1).permute(0, 2, 1).reshape(b * t, c, h, w)
        y = self.proj(y)
        return y.view(b, t, c, h, w).transpose(1, 2) + identity


def _head(dim, out):
    return nn.Sequential(RMS_norm(dim, images=False), nn.SiLU(),
                         CausalConv3d(dim, out, 3, padding=1))


def _run(seq, x, cache):
    for layer in seq:
        x = (layer(x, cache)
             if isinstance(layer, (CausalConv3d, ResidualBlock, Resample,
                                   AttentionBlock)) else layer(x))
    return x


class Encoder3d(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks,
                 temperal_downsample):
        super().__init__()
        dims = [dim * u for u in [1] + dim_mult]
        self.conv1 = CausalConv3d(3, dims[0], 3, padding=1)
        downs = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(num_res_blocks):
                downs.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                downs.append(Resample(out_dim, "downsample3d"
                                      if temperal_downsample[i]
                                      else "downsample2d"))
        self.downsamples = nn.Sequential(*downs)
        self.middle = nn.Sequential(ResidualBlock(out_dim, out_dim),
                                    AttentionBlock(out_dim),
                                    ResidualBlock(out_dim, out_dim))
        self.head = _head(out_dim, z_dim)

    def forward(self, x, cache):
        x = self.conv1(x, cache)
        x = _run(self.downsamples, x, cache)
        x = _run(self.middle, x, cache)
        return _run(self.head, x, cache)


class Decoder3d(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks,
                 temperal_upsample):
        super().__init__()
        dims = [dim * u for u in [dim_mult[-1]] + dim_mult[::-1]]
        self.conv1 = CausalConv3d(z_dim, dims[0], 3, padding=1)
        self.middle = nn.Sequential(ResidualBlock(dims[0], dims[0]),
                                    AttentionBlock(dims[0]),
                                    ResidualBlock(dims[0], dims[0]))
        ups = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            if i in (1, 2, 3):
                in_dim = in_dim // 2
            for _ in range(num_res_blocks + 1):
                ups.append(ResidualBlock(in_dim, out_dim))
                in_dim = out_dim
            if i != len(dim_mult) - 1:
                ups.append(Resample(out_dim, "upsample3d"
                                    if temperal_upsample[i]
                                    else "upsample2d"))
        self.upsamples = nn.Sequential(*ups)
        self.head = _head(out_dim, 3)

    def forward(self, x, cache):
        x = self.conv1(x, cache)
        x = _run(self.middle, x, cache)
        x = _run(self.upsamples, x, cache)
        return _run(self.head, x, cache)


class WanVAE(nn.Module):
    """WanVAE_; encode and decode take and give one clip, (C, T, H, W).
    The latent is the encoder's own: the published latent mean / std
    table (WanVAE's `scale`) is not applied."""

    def __init__(self, dim, z_dim, dim_mult, num_res_blocks,
                 temperal_downsample):
        super().__init__()
        dim_mult = list(dim_mult)
        self.z_dim = z_dim
        self.encoder = Encoder3d(dim, z_dim * 2, dim_mult, num_res_blocks,
                                 list(temperal_downsample))
        self.conv1 = CausalConv3d(z_dim * 2, z_dim * 2, 1)
        self.conv2 = CausalConv3d(z_dim, z_dim, 1)
        self.decoder = Decoder3d(dim, z_dim, dim_mult, num_res_blocks,
                                 list(temperal_downsample)[::-1])

    def encode(self, x):
        """(3, 1 + 4n, H, W) in [-1, 1] -> (z_dim, 1 + n, H/8, W/8)
        float32: the first frame alone, then 4 at a time."""
        x = x.unsqueeze(0)
        cache, outs = {}, []
        for s in [0] + list(range(1, x.shape[2], 4)):
            outs.append(self.encoder(x[:, :, s: s + (4 if s else 1)], cache))
        return self.conv1(torch.cat(outs, 2))[0, :self.z_dim].float()

    def decode(self, z):
        """(z_dim, T, h, w) -> (3, 1 + 4 (T - 1), 8 h, 8 w) in [-1, 1],
        float32: one latent frame at a time."""
        x = self.conv2(z.to(self.conv2.weight.dtype).unsqueeze(0))
        cache, outs = {}, []
        for i in range(x.shape[2]):
            outs.append(self.decoder(x[:, :, i: i + 1], cache))
        return torch.cat(outs, 2)[0].float().clamp_(-1.0, 1.0)
