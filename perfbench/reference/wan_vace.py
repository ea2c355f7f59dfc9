"""Wan2.1-VACE-1.3B masked video-to-video inpainting in plain PyTorch: the
benchmark's reference for the vace cell.

It imports nothing of the program under test and no kernel. It follows
the published code (Wan-Video/Wan2.1 wan/modules/model.py, vae.py;
ali-vilab/VACE vace/models/wan/modules/model.py, wan_vace.py) in float32:
the DiT's q / k RMS norms, 3-D RoPE in complex float64 as `rope_apply`,
full self-attention computed a block of queries at a time (so S = 32,760
fits), cross-attention over all 512 context rows, the float32
modulations, VACE's context blocks and hints; the VAE's causal
convolutions over the whole clip at once, without the frame cache (each
a sum over its time taps of 2-D convolutions, with zero frames in front),
its temporal down- and upsampling written for the whole clip. Frames are
processed in chunks only where an operation is frame by frame or a
convolution's output frames are independent, to bound memory.

Departures from the published pipeline:
- Euler steps on the shifted flow-matching schedule, in place of Wan's
  UniPC multistep solver (same sigmas and timesteps);
- no text encoder: the prompt embeddings (umT5-XXL's outputs) are given;
- the composite: the decoded frames are kept only inside the mask, the
  input frames outside it, as the serving path composites.

Every product goes through `Ops` (reference/model.py): float32, or with
both operands rounded to a narrower type first (the control).
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import Ops

# frames a chunk of a frame-by-frame operation; query rows an attention
# block
FRAME_CHUNK = 8
QUERY_BLOCK = 2048
NUM_TRAIN_TIMESTEPS = 1000


# ---------------------------------------------------------------------------
# Parameter trees (the released checkpoints' names)
# ---------------------------------------------------------------------------

def _linear(i, o):
    return nn.Linear(i, o)


class _Norm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class _Attn(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.q, self.k, self.v, self.o = (_linear(dim, dim) for _ in range(4))
        self.norm_q, self.norm_k = _Norm(dim), _Norm(dim)


class _Block(nn.Module):
    def __init__(self, dim, ffn_dim, block_id=None):
        super().__init__()
        self.self_attn = _Attn(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.cross_attn = _Attn(dim)
        self.ffn = nn.Sequential(_linear(dim, ffn_dim), nn.Identity(),
                                 _linear(ffn_dim, dim))
        self.modulation = nn.Parameter(torch.zeros(1, 6, dim))
        if block_id == 0:
            self.before_proj = _linear(dim, dim)
        if block_id is not None:
            self.after_proj = _linear(dim, dim)


class _Head(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.head = _linear(dim, out)
        self.modulation = nn.Parameter(torch.zeros(1, 2, dim))


class DiT(nn.Module):
    def __init__(self, dim, ffn_dim, freq_dim, text_dim, text_len, in_dim,
                 out_dim, num_heads, num_layers, patch_size, eps, vace_layers,
                 vace_in_dim):
        super().__init__()
        self.cfg = dict(dim=dim, freq_dim=freq_dim, text_len=text_len,
                        out_dim=out_dim, num_heads=num_heads,
                        patch_size=tuple(patch_size), eps=eps,
                        vace_layers=list(vace_layers))
        self.patch_embedding = nn.Conv3d(in_dim, dim, patch_size, patch_size)
        self.text_embedding = nn.Sequential(_linear(text_dim, dim),
                                            nn.Identity(), _linear(dim, dim))
        self.time_embedding = nn.Sequential(_linear(freq_dim, dim),
                                            nn.Identity(), _linear(dim, dim))
        self.time_projection = nn.Sequential(nn.Identity(),
                                             _linear(dim, 6 * dim))
        self.blocks = nn.ModuleList([_Block(dim, ffn_dim)
                                     for _ in range(num_layers)])
        self.head = _Head(dim, math.prod(patch_size) * out_dim)
        self.vace_blocks = nn.ModuleList([_Block(dim, ffn_dim, i)
                                          for i in range(len(vace_layers))])
        self.vace_patch_embedding = nn.Conv3d(vace_in_dim, dim, patch_size,
                                              patch_size)


class _RMS(nn.Module):
    def __init__(self, dim, images=False):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones((dim, 1, 1) if images
                                             else (dim, 1, 1, 1)))


class _Conv(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        k = (k,) * 3 if isinstance(k, int) else tuple(k)
        self.weight = nn.Parameter(torch.zeros(cout, cin, *k))
        self.bias = nn.Parameter(torch.zeros(cout))


class _Res(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.residual = nn.Sequential(_RMS(i), nn.Identity(), _Conv(i, o, 3),
                                      _RMS(o), nn.Identity(), nn.Identity(),
                                      _Conv(o, o, 3))
        if i != o:
            self.shortcut = _Conv(i, o, 1)


class _AttnBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = _RMS(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1)
        self.proj = nn.Conv2d(dim, dim, 1)


class _Resample(nn.Module):
    def __init__(self, dim, mode):
        super().__init__()
        self.mode = mode
        out = dim // 2 if mode.startswith("up") else dim
        self.resample = nn.Sequential(nn.Identity(),
                                      nn.Conv2d(dim, out, 3))
        if mode == "upsample3d":
            self.time_conv = _Conv(dim, 2 * dim, (3, 1, 1))
        elif mode == "downsample3d":
            self.time_conv = _Conv(dim, dim, (3, 1, 1))


class _Coder(nn.Module):
    def __init__(self, dim, z, dim_mult, nres, temporal, decoder):
        super().__init__()
        if decoder:
            dims = [dim * u for u in [dim_mult[-1]] + dim_mult[::-1]]
            self.conv1 = _Conv(z, dims[0], 3)
            self.middle = nn.Sequential(_Res(dims[0], dims[0]),
                                        _AttnBlock(dims[0]),
                                        _Res(dims[0], dims[0]))
        else:
            dims = [dim * u for u in [1] + dim_mult]
            self.conv1 = _Conv(3, dims[0], 3)
        stages = []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            if decoder and i > 0:
                a //= 2
            for _ in range(nres + (1 if decoder else 0)):
                stages.append(_Res(a, b))
                a = b
            if i != len(dim_mult) - 1:
                kind = ("upsample" if decoder else "downsample") + \
                    ("3d" if temporal[i] else "2d")
                stages.append(_Resample(b, kind))
        if decoder:
            self.upsamples = nn.Sequential(*stages)
        else:
            self.downsamples = nn.Sequential(*stages)
            self.middle = nn.Sequential(_Res(b, b), _AttnBlock(b), _Res(b, b))
        self.head = nn.Sequential(_RMS(b), nn.Identity(),
                                  _Conv(b, 3 if decoder else z, 3))


class VAE(nn.Module):
    def __init__(self, dim, z_dim, dim_mult, num_res_blocks,
                 temperal_downsample):
        super().__init__()
        dim_mult, td = list(dim_mult), list(temperal_downsample)
        self.z_dim = z_dim
        self.encoder = _Coder(dim, 2 * z_dim, dim_mult, num_res_blocks, td,
                              False)
        self.conv1 = _Conv(2 * z_dim, 2 * z_dim, 1)
        self.conv2 = _Conv(z_dim, z_dim, 1)
        self.decoder = _Coder(dim, z_dim, dim_mult, num_res_blocks, td[::-1],
                              True)


def param_shapes(config):
    """{'dit': [(name, shape)], 'vae': [...]} of `config` ({'dit': kwargs,
    'vae': kwargs}), in the state dicts' order."""
    with torch.device("meta"):
        trees = {"dit": DiT(**config["dit"]), "vae": VAE(**config["vae"])}
    return {k: [(n, tuple(p.shape)) for n, p in m.state_dict().items()]
            for k, m in trees.items()}


def build(config, state_dicts, device):
    """The DiT and the VAE holding the given float32 state dicts' tensors
    (made on `device`)."""
    with torch.device("meta"):
        dit, vae = DiT(**config["dit"]), VAE(**config["vae"])
    dit.load_state_dict(state_dicts["dit"], strict=True, assign=True)
    vae.load_state_dict(state_dicts["vae"], strict=True, assign=True)
    return dit.to(device).float().eval(), vae.to(device).float().eval()


# ---------------------------------------------------------------------------
# The DiT
# ---------------------------------------------------------------------------

def _lin(ops, x, m):
    return ops.linear(x, m.weight, m.bias)


def _layer_norm(x, eps, mod=None):
    return F.layer_norm(x, x.shape[-1:], None if mod is None else mod.weight,
                        None if mod is None else mod.bias, eps)


def _rms(x, mod, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * mod.weight


def sinusoidal_embedding_1d(dim, position):
    half = dim // 2
    position = position.type(torch.float64)
    sinusoid = torch.outer(position, torch.pow(
        10000, -torch.arange(half).to(position).div(half)))
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def rope_params(max_seq_len, dim, theta=10000):
    freqs = torch.outer(torch.arange(max_seq_len), 1.0 / torch.pow(
        theta, torch.arange(0, dim, 2).to(torch.float64).div(dim)))
    return torch.polar(torch.ones_like(freqs), freqs)


def rope_freqs(head_dim):
    d = head_dim
    return torch.cat([rope_params(1024, d - 4 * (d // 6)),
                      rope_params(1024, 2 * (d // 6)),
                      rope_params(1024, 2 * (d // 6))], dim=1)


def rope_apply(x, grid, freqs):
    """x (S, n, d) float32 rotated on the (f, h, w) grid, in complex
    float64 (Wan's rope_apply for one sample)."""
    s, n, c = x.shape[0], x.shape[1], x.shape[2] // 2
    f, h, w = grid
    parts = freqs.to(x.device).split([c - 2 * (c // 3), c // 3, c // 3],
                                     dim=1)
    fr = torch.cat([parts[0][:f].view(f, 1, 1, -1).expand(f, h, w, -1),
                    parts[1][:h].view(1, h, 1, -1).expand(f, h, w, -1),
                    parts[2][:w].view(1, 1, w, -1).expand(f, h, w, -1)],
                   dim=-1).reshape(s, 1, -1)
    xc = torch.view_as_complex(x.to(torch.float64).reshape(s, n, -1, 2))
    return torch.view_as_real(xc * fr).flatten(2).float()


def attention(ops, q, k, v, block=QUERY_BLOCK):
    """softmax(q k^T / sqrt d) v, (S, n, d) q against (L, n, d) k and v, a
    block of queries at a time; float32 scores."""
    kt = ops.q(k.permute(1, 2, 0))                 # (n, d, L)
    vv = ops.q(v.transpose(0, 1))                  # (n, L, d)
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    for a in range(0, q.shape[0], block):
        qb = ops.q(q[a: a + block].transpose(0, 1))        # (n, b, d)
        p = torch.softmax(torch.matmul(qb, kt) * scale, dim=-1)
        out[a: a + block] = torch.matmul(ops.q(p), vv).transpose(0, 1)
    return out


def _self_attn(ops, m, x, grid, freqs, n, eps):
    s = x.shape[0]
    q = _rms(_lin(ops, x, m.q), m.norm_q, eps).view(s, n, -1)
    k = _rms(_lin(ops, x, m.k), m.norm_k, eps).view(s, n, -1)
    v = _lin(ops, x, m.v).view(s, n, -1)
    y = attention(ops, rope_apply(q, grid, freqs), rope_apply(k, grid, freqs),
                  v)
    return _lin(ops, y.flatten(1), m.o)


def _cross_attn(ops, m, x, ctx, n, eps):
    q = _rms(_lin(ops, x, m.q), m.norm_q, eps).view(x.shape[0], n, -1)
    k = _rms(_lin(ops, ctx, m.k), m.norm_k, eps).view(ctx.shape[0], n, -1)
    v = _lin(ops, ctx, m.v).view(ctx.shape[0], n, -1)
    return _lin(ops, attention(ops, q, k, v).flatten(1), m.o)


def block_forward(ops, blk, x, e0, grid, freqs, ctx, n, eps):
    """WanAttentionBlock on (S, dim) float32 tokens; e0 (6, dim)."""
    e = (blk.modulation[0] + e0).chunk(6, dim=0)
    y = _self_attn(ops, blk.self_attn,
                   _layer_norm(x, eps) * (1 + e[1]) + e[0], grid, freqs, n,
                   eps)
    x = x + y * e[2]
    x = x + _cross_attn(ops, blk.cross_attn, _layer_norm(x, eps, blk.norm3),
                        ctx, n, eps)
    h = _lin(ops, _layer_norm(x, eps) * (1 + e[4]) + e[3], blk.ffn[0])
    y = _lin(ops, F.gelu(h, approximate="tanh"), blk.ffn[2])
    return x + y * e[5]


def _patchify(ops, conv, x, p):
    """(C, f, H, W) -> (S, dim) by the (1, 2, 2) Conv3d as a product."""
    c, f, hh, ww = x.shape
    t = x.view(c, f // p[0], p[0], hh // p[1], p[1], ww // p[2], p[2])
    t = t.permute(1, 3, 5, 0, 2, 4, 6).reshape(-1, c * math.prod(p))
    return ops.linear(t, conv.weight.reshape(conv.weight.shape[0], -1),
                      conv.bias)


def dit_forward(ops, dit, x, t, vace_ctx, context, freqs=None,
                hints_on=True):
    """VaceWanModel.forward for one clip: x (16, f, H, W) latent, t (1,)
    timestep, vace_ctx (96, f, H, W), context (text_len, text_dim) ->
    (16, f, H, W) velocity. hints_on=False drops the context branch (a
    fault the tests show)."""
    cfg = dit.cfg
    p, dim, n, eps = cfg["patch_size"], cfg["dim"], cfg["num_heads"], \
        cfg["eps"]
    grid = [s // q for s, q in zip(x.shape[1:], p)]
    freqs = rope_freqs(dim // n) if freqs is None else freqs
    h = _patchify(ops, dit.patch_embedding, x.float(), p)
    te = dit.time_embedding
    e = _lin(ops, F.silu(_lin(ops, sinusoidal_embedding_1d(
        cfg["freq_dim"], t).float(), te[0])), te[2])
    e0 = _lin(ops, F.silu(e), dit.time_projection[1]).view(6, dim)
    ctx = _lin(ops, F.gelu(_lin(ops, context.float(), dit.text_embedding[0]),
                           approximate="tanh"), dit.text_embedding[2])

    c = _lin(ops, _patchify(ops, dit.vace_patch_embedding, vace_ctx.float(),
                            p), dit.vace_blocks[0].before_proj) + h
    hints = []
    for blk in dit.vace_blocks:
        c = block_forward(ops, blk, c, e0, grid, freqs, ctx, n, eps)
        hints.append(_lin(ops, c, blk.after_proj))
    for i, blk in enumerate(dit.blocks):
        h = block_forward(ops, blk, h, e0, grid, freqs, ctx, n, eps)
        if hints_on and i in cfg["vace_layers"]:
            h = h + hints[cfg["vace_layers"].index(i)]
    em = (dit.head.modulation[0] + e).chunk(2, dim=0)
    out = _lin(ops, _layer_norm(h, eps) * (1 + em[1]) + em[0], dit.head.head)
    f, hh, ww = grid
    out = out.view(f, hh, ww, *p, cfg["out_dim"])
    out = torch.einsum("fhwpqrc->cfphqwr", out)
    return out.reshape(cfg["out_dim"], f * p[0], hh * p[1], ww * p[2])


def guided_velocity(ops, dit, x, t, vace_ctx, context, context_null,
                    guidance, **kw):
    """v_u + g (v_c - v_u) at latent x and timestep t."""
    v_c = dit_forward(ops, dit, x, t, vace_ctx, context, **kw)
    v_u = dit_forward(ops, dit, x, t, vace_ctx, context_null, **kw)
    return v_u + guidance * (v_c - v_u)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

def schedule(steps, shift):
    """(timesteps int64, sigmas float32 with a final 0): Wan's
    FlowUniPCMultistepScheduler.set_timesteps at `shift`."""
    train = 1.0 - np.linspace(1, 1 / NUM_TRAIN_TIMESTEPS,
                              NUM_TRAIN_TIMESTEPS)[::-1]
    sigma_max = torch.from_numpy(train.copy()).float()[0].item()
    sigma_min = float(train[-1])
    sig = np.linspace(sigma_max, sigma_min, steps + 1).copy()[:-1]
    sig = shift * sig / (1 + (shift - 1) * sig)
    timesteps = (sig * NUM_TRAIN_TIMESTEPS).astype(np.int64)
    return timesteps, np.concatenate([sig, [0.0]]).astype(np.float32)


def sample(ops, dit, vace_ctx, noise, context, context_null, steps, shift,
           guidance):
    """Euler steps from the noise; returns (latent, [latent a step])."""
    timesteps, sigmas = schedule(steps, shift)
    x, seen = noise.float(), []
    for i in range(steps):
        seen.append(x)
        t = torch.tensor([float(timesteps[i])], device=x.device)
        v = guided_velocity(ops, dit, x, t, vace_ctx, context, context_null,
                            guidance)
        x = x + (float(sigmas[i + 1]) - float(sigmas[i])) * v
    return x, seen


# ---------------------------------------------------------------------------
# The VAE, whole clip; frame-first tensors (T, C, H, W)
# ---------------------------------------------------------------------------

def _frames(fn, x, *args, chunk=FRAME_CHUNK):
    """fn over chunks of frames (a frame-by-frame operation), written into
    one output."""
    out = None
    for a in range(0, x.shape[0], chunk):
        y = fn(x[a: a + chunk], *args)
        if out is None:
            out = y.new_empty((x.shape[0], *y.shape[1:]))
        out[a: a + len(y)] = y
    return out


def _conv2d(ops, x, w, b, stride=1, padding=0):
    return F.conv2d(ops.q(x), ops.q(w), b, stride=stride, padding=padding)


def causal_conv(ops, conv, x, stride=1, pad_t=None, chunk=FRAME_CHUNK):
    """A causal 3-D convolution over the whole clip: (T, Cin, H, W) ->
    (T', Cout, H, W); `pad_t` zero frames in front (default kt - 1),
    spatial padding kh // 2, output frame j the sum over taps i of the
    2-D convolution of input frame j * stride + i - pad_t with tap i."""
    w = conv.weight
    kt, kh = w.shape[2], w.shape[3]
    pad_t = kt - 1 if pad_t is None else pad_t
    t_out = max((x.shape[0] + pad_t - kt) // stride + 1, 0)
    out = x.new_empty((t_out, w.shape[0], *x.shape[2:]))
    for a in range(0, t_out, chunk):
        n = min(chunk, t_out - a)
        lo, hi = a * stride - pad_t, (a + n - 1) * stride + kt - pad_t
        slab = x[max(lo, 0): hi]
        if lo < 0:
            slab = torch.cat([slab.new_zeros((-lo, *slab.shape[1:])), slab])
        y = None
        for i in range(kt):
            part = _conv2d(ops, slab[i: i + (n - 1) * stride + 1: stride],
                           w[:, :, i], conv.bias if i == 0 else None,
                           padding=kh // 2)
            y = part if y is None else y.add_(part)
        out[a: a + n] = y
    return out


def _rms_silu(x, mod, silu=True):
    """Wan's RMS_norm over the channels (sqrt(C) x / ||x||, times gamma),
    then SiLU."""
    def fn(t):
        g = mod.gamma.view(1, -1, 1, 1)
        y = F.normalize(t, dim=1) * (t.shape[1] ** 0.5) * g
        return F.silu(y) if silu else y
    return _frames(fn, x)


def _res(ops, m, x):
    h = x if not hasattr(m, "shortcut") else causal_conv(ops, m.shortcut, x)
    y = causal_conv(ops, m.residual[2], _rms_silu(x, m.residual[0]))
    a = _rms_silu(y, m.residual[3])
    del y                               # three clips live at most
    return causal_conv(ops, m.residual[6], a).add_(h)


def _attn_block(ops, m, x):
    def fn(t):
        n, c, hh, ww = t.shape
        y = _rms_silu(t, m.norm, silu=False)
        qkv = _conv2d(ops, y, m.to_qkv.weight, m.to_qkv.bias)
        qkv = qkv.reshape(n, 3 * c, hh * ww)
        out = []
        for i in range(n):
            q, k, v = qkv[i].t().unsqueeze(1).chunk(3, dim=-1)   # (L, 1, c)
            out.append(attention(ops, q, k, v)[:, 0].t())
        y = torch.stack(out).reshape(n, c, hh, ww)
        return _conv2d(ops, y, m.proj.weight, m.proj.bias) + t
    return _frames(fn, x)


def _resample(ops, m, x):
    conv = m.resample[1]
    if m.mode == "upsample3d":
        y = causal_conv(ops, m.time_conv, x[1:])
        c = x.shape[1]
        y = torch.stack([y[:, :c], y[:, c:]], 1).flatten(0, 1)
        x = torch.cat([x[:1], y])
    if m.mode.startswith("upsample"):
        def fn(t):
            t = F.interpolate(t, scale_factor=2.0, mode="nearest-exact")
            return _conv2d(ops, t, conv.weight, conv.bias, padding=1)
    else:
        def fn(t):
            return _conv2d(ops, F.pad(t, (0, 1, 0, 1)), conv.weight,
                           conv.bias, stride=2)
    x = _frames(fn, x)
    if m.mode == "downsample3d":
        x = torch.cat([x[:1], causal_conv(ops, m.time_conv, x, stride=2,
                                          pad_t=0)])
    return x


def _stages(ops, seq, x):
    for m in seq:
        if isinstance(m, _Res):
            x = _res(ops, m, x)
        elif isinstance(m, _AttnBlock):
            x = _attn_block(ops, m, x)
        else:
            x = _resample(ops, m, x)
    return x


def _head(ops, head, x):
    return causal_conv(ops, head[2], _rms_silu(x, head[0]))


def vae_encode(ops, vae, clip):
    """(3, T, H, W) in [-1, 1] -> (z_dim, 1 + (T - 1) / 4, H/8, W/8)."""
    enc = vae.encoder
    x = causal_conv(ops, enc.conv1, clip.float().transpose(0, 1))
    x = _stages(ops, enc.downsamples, x)
    x = _stages(ops, enc.middle, x)
    x = causal_conv(ops, vae.conv1, _head(ops, enc.head, x))
    return x[:, :vae.z_dim].transpose(0, 1)


def vae_decode(ops, vae, z):
    """(z_dim, T, h, w) -> (3, 1 + 4 (T - 1), 8 h, 8 w), clamped to
    [-1, 1]."""
    dec = vae.decoder
    x = causal_conv(ops, vae.conv2, z.float().transpose(0, 1))
    x = causal_conv(ops, dec.conv1, x)
    x = _stages(ops, dec.middle, x)
    x = _stages(ops, dec.upsamples, x)
    return _head(ops, dec.head, x).clamp_(-1.0, 1.0).transpose(0, 1)


# ---------------------------------------------------------------------------
# VACE's inputs and the composite
# ---------------------------------------------------------------------------

def vace_encode_masks(mask, vae_stride=(4, 8, 8)):
    """(1, T, H, W) mask -> (64, (T + 3) // 4, H/8, W/8)."""
    _, depth, height, width = mask.shape
    new_depth = int((depth + 3) // vae_stride[0])
    height = 2 * (int(height) // (vae_stride[1] * 2))
    width = 2 * (int(width) // (vae_stride[2] * 2))
    m = mask[0].view(depth, height, vae_stride[1], width, vae_stride[1])
    m = m.permute(2, 4, 0, 1, 3).reshape(vae_stride[1] * vae_stride[2],
                                         depth, height, width)
    return F.interpolate(m.unsqueeze(0), size=(new_depth, height, width),
                         mode="nearest-exact").squeeze(0)


def vace_context(ops, vae, frames, masks):
    """(96, f, h, w): frames (T, H, W, 3) uint8 and masks (T, H, W) {0, 1}
    tensors."""
    f = frames.permute(3, 0, 1, 2).float() / 255.0 * 2.0 - 1.0
    m = torch.where(masks.float() > 0.5, 1.0, 0.0)[None]
    inactive = vae_encode(ops, vae, f * (1 - m))
    reactive = vae_encode(ops, vae, f * m)
    return torch.cat([inactive, reactive, vace_encode_masks(m)], 0)


def to_frames(video):
    """(3, T, H, W) in [-1, 1] -> (T, H, W, 3) uint8, truncated."""
    return ((video.permute(1, 2, 3, 0) + 1.0) / 2.0 * 255.0).clamp(
        0.0, 255.0).to(torch.uint8)


def composite(pred, orig, binary):
    """pred (T, H, W, 3) uint8 inside the mask, orig outside; numpy."""
    return np.where(np.asarray(binary)[..., :1] != 0, np.asarray(pred),
                    np.asarray(orig))


def inpaint(ops, dit, vae, frames, masks, noise, context, context_null,
            steps, shift, guidance):
    """The whole path for a clip of 1 + 4n frames: (T, H, W, 3) uint8 numpy
    frames, (T, H, W, 1) masks -> (composite uint8 numpy, final latent)."""
    device = noise.device
    fr = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    mk = torch.from_numpy(np.ascontiguousarray(masks[..., 0])).to(device)
    ctx = vace_context(ops, vae, fr, mk)
    x, _ = sample(ops, dit, ctx, noise, context, context_null, steps, shift,
                  guidance)
    pred = to_frames(vae_decode(ops, vae, x)).cpu().numpy()
    return composite(pred, frames, masks), x
