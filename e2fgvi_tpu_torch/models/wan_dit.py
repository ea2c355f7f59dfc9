"""Wan2.1's diffusion transformer with VACE's context branch
(Wan-Video/Wan2.1 wan/modules/model.py: WanModel, WanAttentionBlock,
rope_params, rope_apply, sinusoidal_embedding_1d; ali-vilab/VACE
vace/models/wan/modules/model.py: VaceWanModel, VaceWanAttentionBlock,
BaseWanAttentionBlock). The module tree has the released checkpoint's
names, so Wan2.1-VACE-1.3B's state dict loads as it is.

Precision as Wan runs it under autocast: the linears, the patch
embeddings and attention in the weights' dtype (bfloat16 when served);
the time embedding, its 6 x dim projection, every modulation, the
layer norms and RMS norms, the residual stream and the head in float32
(`cast` leaves their parameters float32). RoPE is applied in float32 (Wan:
float64) before q and k are rounded to the attention's dtype.

The self-attention over all S = f * h * w tokens is `self_attention`,
looked up at call time (a profiler range can wrap it).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# modules and parameters that stay float32 when the model is cast
FLOAT32 = ("time_embedding", "time_projection", "head", "modulation",
           "norm3", "norm_q", "norm_k")


def self_attention(q, k, v):
    """(B, heads, S, d) each -> (B, heads, S, d): softmax(q k^T / sqrt d) v
    over every token."""
    return F.scaled_dot_product_attention(q, k, v)


def sinusoidal_embedding(dim, t):
    """(n,) positions -> (n, dim) float32 [cos | sin], computed in float64
    as Wan does."""
    half = dim // 2
    pos = t.to(torch.float64)
    freqs = torch.pow(10000, -torch.arange(half, dtype=torch.float64,
                                           device=t.device).div(half))
    s = torch.outer(pos, freqs)
    return torch.cat([torch.cos(s), torch.sin(s)], dim=1).float()


def rope_angles(grid, head_dim, device, theta=10000.0):
    """(S, head_dim / 2) float32 cos and sin of the 3-D rotary angles on an
    (f, h, w) grid, token order f, h, w: the head's pairs split t / h / w
    as d - 4 (d // 6), 2 (d // 6), 2 (d // 6) dimensions (44 / 42 / 42 at
    d = 128), each part's frequencies theta^(-2i / part)."""
    f, h, w = grid
    third = head_dim // 6
    parts = (head_dim - 4 * third, 2 * third, 2 * third)
    angles = []
    for n, dim, shape in zip((f, h, w), parts,
                             ((f, 1, 1), (1, h, 1), (1, 1, w))):
        inv = 1.0 / torch.pow(theta, torch.arange(
            0, dim, 2, dtype=torch.float64, device=device).div(dim))
        a = torch.outer(torch.arange(n, dtype=torch.float64, device=device),
                        inv)
        angles.append(a.view(*shape, -1).expand(f, h, w, -1))
    a = torch.cat(angles, -1).reshape(f * h * w, -1)
    return torch.cos(a).float(), torch.sin(a).float()


def rope_apply(x, cos, sin):
    """Rotate the consecutive pairs of (B, S, heads, d) x by (S, d / 2)
    angles; float32 out."""
    x = x.float().unflatten(-1, (-1, 2))
    a, b = x[..., 0], x[..., 1]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([a * c - b * s, a * s + b * c], -1).flatten(-2)


class RMSNorm(nn.Module):
    """WanRMSNorm: over the last dimension in float32, times the gain."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight.float()


class LayerNorm(nn.LayerNorm):
    """WanLayerNorm: in float32; float32 out."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            None if self.weight is None
                            else self.weight.float(),
                            None if self.bias is None else self.bias.float(),
                            self.eps)


def linear(mod, x):
    """The Linear in its weights' dtype (autocast's cast of x)."""
    return mod(x.to(mod.weight.dtype))


class SelfAttention(nn.Module):
    def __init__(self, dim, num_heads, eps=1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.norm_q = RMSNorm(dim, eps)
        self.norm_k = RMSNorm(dim, eps)

    def forward(self, x, rope):
        b, s, _ = x.shape
        dt = self.q.weight.dtype

        def heads(t):
            return t.view(b, s, self.num_heads, -1)
        q = rope_apply(heads(self.norm_q(linear(self.q, x))), *rope)
        k = rope_apply(heads(self.norm_k(linear(self.k, x))), *rope)
        v = heads(linear(self.v, x))
        y = self_attention(q.to(dt).transpose(1, 2), k.to(dt).transpose(1, 2),
                           v.transpose(1, 2))
        return linear(self.o, y.transpose(1, 2).flatten(2))


class CrossAttention(SelfAttention):
    def forward(self, x, context):
        b, n = x.shape[0], self.num_heads
        dt = self.q.weight.dtype
        q = self.norm_q(linear(self.q, x)).to(dt).view(b, -1, n,
                                                       x.shape[-1] // n)
        k = self.norm_k(linear(self.k, context)).to(dt).view(b, -1, n,
                                                             q.shape[-1])
        v = linear(self.v, context).view(b, -1, n, q.shape[-1])
        y = F.scaled_dot_product_attention(q.transpose(1, 2),
                                           k.transpose(1, 2),
                                           v.transpose(1, 2))
        return linear(self.o, y.transpose(1, 2).flatten(2))


class AttentionBlock(nn.Module):
    """WanAttentionBlock (t2v cross-attention, cross_attn_norm)."""

    def __init__(self, dim, ffn_dim, num_heads, eps=1e-6):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps, elementwise_affine=False)
        self.self_attn = SelfAttention(dim, num_heads, eps)
        self.norm3 = LayerNorm(dim, eps, elementwise_affine=True)
        self.cross_attn = CrossAttention(dim, num_heads, eps)
        self.norm2 = LayerNorm(dim, eps, elementwise_affine=False)
        self.ffn = nn.Sequential(nn.Linear(dim, ffn_dim),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(ffn_dim, dim))
        self.modulation = nn.Parameter(torch.randn(1, 6, dim) / dim ** 0.5)

    def forward(self, x, e0, rope, context):
        e = (self.modulation + e0).chunk(6, dim=1)
        y = self.self_attn(self.norm1(x) * (1 + e[1]) + e[0], rope)
        x = x + y * e[2]
        x = x + self.cross_attn(self.norm3(x), context)
        h = linear(self.ffn[0], self.norm2(x) * (1 + e[4]) + e[3])
        y = self.ffn[2](self.ffn[1](h))
        return x + y * e[5]


class ContextBlock(AttentionBlock):
    """VaceWanAttentionBlock: block 0 adds before_proj(c) to the main
    stream's embedding; every block's output goes on, and after_proj of it
    is a hint for the main block it is paired with."""

    def __init__(self, dim, ffn_dim, num_heads, eps=1e-6, block_id=0):
        super().__init__(dim, ffn_dim, num_heads, eps)
        self.block_id = block_id
        if block_id == 0:
            self.before_proj = nn.Linear(dim, dim)
        self.after_proj = nn.Linear(dim, dim)


class Head(nn.Module):
    def __init__(self, dim, out_dim, patch_size, eps=1e-6):
        super().__init__()
        self.norm = LayerNorm(dim, eps, elementwise_affine=False)
        self.head = nn.Linear(dim, math.prod(patch_size) * out_dim)
        self.modulation = nn.Parameter(torch.randn(1, 2, dim) / dim ** 0.5)

    def forward(self, x, e):
        e = (self.modulation + e.unsqueeze(1)).chunk(2, dim=1)
        return F.linear(self.norm(x) * (1 + e[1]) + e[0],
                        self.head.weight.float(), self.head.bias.float())


class VaceWanModel(nn.Module):
    """VaceWanModel (t2v): `num_layers` main blocks, and context blocks
    paired with the main blocks `vace_layers`, whose hints are added after
    them (wan_vace.PUBLISHED holds the 1.3B model's widths)."""

    def __init__(self, dim, ffn_dim, freq_dim, text_dim, text_len, in_dim,
                 out_dim, num_heads, num_layers, patch_size, eps, vace_layers,
                 vace_in_dim):
        super().__init__()
        self.dim, self.freq_dim, self.text_len = dim, freq_dim, text_len
        self.out_dim, self.patch_size = out_dim, tuple(patch_size)
        self.num_heads = num_heads
        self.patch_embedding = nn.Conv3d(in_dim, dim, kernel_size=patch_size,
                                         stride=patch_size)
        self.text_embedding = nn.Sequential(nn.Linear(text_dim, dim),
                                            nn.GELU(approximate="tanh"),
                                            nn.Linear(dim, dim))
        self.time_embedding = nn.Sequential(nn.Linear(freq_dim, dim),
                                            nn.SiLU(), nn.Linear(dim, dim))
        self.time_projection = nn.Sequential(nn.SiLU(),
                                             nn.Linear(dim, dim * 6))
        self.blocks = nn.ModuleList([AttentionBlock(dim, ffn_dim, num_heads,
                                                    eps)
                                     for _ in range(num_layers)])
        self.head = Head(dim, out_dim, patch_size, eps)
        self.vace_layers = list(vace_layers)
        self.hint_of = {layer: n for n, layer in enumerate(self.vace_layers)}
        self.vace_blocks = nn.ModuleList([
            ContextBlock(dim, ffn_dim, num_heads, eps, block_id=n)
            for n in range(len(self.vace_layers))])
        self.vace_patch_embedding = nn.Conv3d(vace_in_dim, dim,
                                              kernel_size=patch_size,
                                              stride=patch_size)
        self._rope = {}

    def cast(self, dtype):
        """Parameters to dtype, except those Wan computes in float32."""
        for name, p in self.named_parameters():
            if not any(part in FLOAT32 for part in name.split(".")):
                p.data = p.data.to(dtype)
        return self

    def rope(self, grid, device):
        """The (cos, sin) tables of a grid, made once per grid."""
        key = (tuple(grid), device)
        if key not in self._rope:
            self._rope[key] = rope_angles(grid, self.dim // self.num_heads,
                                          device)
        return self._rope[key]

    def embed(self, conv, x):
        """(C, f, H, W) -> (1, S, dim) patch tokens in the weights' dtype."""
        return conv(x.to(conv.weight.dtype).unsqueeze(0)).flatten(2) \
            .transpose(1, 2)

    def forward(self, x, t, vace_context, context, spans=None):
        """x: (16, f, H, W) latent; t: (1,) timestep; vace_context: (96, f,
        H, W); context: (text_len, text_dim) embedded prompt. spans: a
        StageTimer (or stand-in) that gets `dit_context` around the context
        blocks. Returns the (16, f, H, W) float32 velocity."""
        p = self.patch_size
        grid = [n // s for n, s in zip(x.shape[1:], p)]
        rope = self.rope(grid, x.device)
        h = self.embed(self.patch_embedding, x)
        e = self.time_embedding(sinusoidal_embedding(self.freq_dim, t))
        e0 = self.time_projection(e).unflatten(1, (6, self.dim))
        ctx = linear(self.text_embedding[0], context.unsqueeze(0))
        ctx = self.text_embedding[2](self.text_embedding[1](ctx))

        if spans is not None:
            spans.begin("dit_context")
        c = linear(self.vace_blocks[0].before_proj,
                   self.embed(self.vace_patch_embedding, vace_context)) + h
        hints = []
        for block in self.vace_blocks:
            c = block(c, e0, rope, ctx)
            hints.append(linear(block.after_proj, c))
        if spans is not None:
            spans.end("dit_context")

        for i, block in enumerate(self.blocks):
            h = block(h, e0, rope, ctx)
            if i in self.hint_of:
                h = h + hints[self.hint_of[i]]
        out = self.head(h, e)[0]
        f, hh, ww = grid
        out = out.view(f, hh, ww, *p, self.out_dim)
        return out.permute(6, 0, 3, 1, 4, 2, 5).reshape(
            self.out_dim, f * p[0], hh * p[1], ww * p[2])
