"""Temporal focal transformer: soft split / focal window attention / soft
composition / F3N feed-forward, channel-last.

Counterpart of e2fgvi_tpu/models/tfocal.py (reference
model/modules/tfocal_transformer.py). Weights keep the released
checkpoint's layout: patch features are channel-major (c*49 + k), which is
the order F.unfold / F.fold use, so no permutation is needed.

Window attention is the JAX package's fused formulation
(_window_attention_fused): per-head q/k/v maps, the window's own keys and
the rolled + pooled keys gathered through the deduplicated static key
table, with per-key biases (ln(multiplicity) on deduplicated slots, -100
outside the pooled grid, -1e9 on padding frames). Where the JAX package
passes the two key sets as two panels, the port gathers both into one
contiguous key panel per window (one index_select per k and v) with one
joined bias row. The softmax over the panel is K3
(kernels/focal_attention.py).

Static geometry at the base model: a 20x36 token grid, (5, 9) windows,
(2, 4) expansion, one pooled level of 4x4 window tokens. The HQ model
takes the grid from the input size (864x480: 40x72 tokens, 64 windows);
the window tables are built per grid and cached.
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from e2fgvi_tpu_torch.kernels.focal_attention import focal_attention
from e2fgvi_tpu_torch.ops.convs import conv2d, gelu, layer_norm, linear
from e2fgvi_tpu_torch.ops.patches import fold, fold_normalized, unfold

T2T_KERNEL = (7, 7)
T2T_STRIDE = (3, 3)
T2T_PADDING = (3, 3)


def token_grid(output_size):
    """Token grid of a feature map (torch Unfold arithmetic)."""
    (kh, kw), (sh, sw), (ph, pw) = T2T_KERNEL, T2T_STRIDE, T2T_PADDING
    return ((output_size[0] + 2 * ph - kh) // sh + 1,
            (output_size[1] + 2 * pw - kw) // sw + 1)


# ---------------------------------------------------------------------------
# Modules (parameter names follow the released checkpoint)
# ---------------------------------------------------------------------------

class SoftSplit(nn.Module):
    def __init__(self, channel=128, hidden=512):
        super().__init__()
        self.embedding = nn.Linear(channel * 49, hidden)


class SoftComp(nn.Module):
    """With an output_size: the base model's learned (C, H, W) bias map.
    Without one: the HQ model's 3x3 `bias_conv`, which takes any size
    (reference tfocal_transformer_hq.py:58-79)."""

    def __init__(self, channel=128, hidden=512, output_size=None):
        super().__init__()
        self.embedding = nn.Linear(hidden, channel * 49)
        if output_size is None:
            self.bias_conv = nn.Conv2d(channel, channel, 3, padding=1)
        else:
            self.bias = nn.Parameter(torch.zeros(channel, *output_size))


class WindowAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class FusionFeedForward(nn.Module):
    def __init__(self, dim, d_ff=1960):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Linear(dim, d_ff))
        self.conv2 = nn.Sequential(nn.GELU(), nn.Linear(d_ff, dim))


class TemporalFocalTransformerBlock(nn.Module):
    def __init__(self, dim=512, window_size=(5, 9), d_ff=1960):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = FusionFeedForward(dim, d_ff)
        self.pool_layers = nn.ModuleList(
            [nn.Linear(window_size[0] * window_size[1], 1)])

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """N(0, 0.02) linears, zero biases, unit norms, mean pooling."""
        for lin in (self.attn.qkv, self.attn.proj, self.mlp.conv1[0],
                    self.mlp.conv2[1]):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             * 0.02)
            lin.bias.zero_()
        for norm in (self.norm1, self.norm2):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        pool = self.pool_layers[0]
        pool.weight.fill_(1.0 / pool.weight.shape[1])
        pool.bias.zero_()


# ---------------------------------------------------------------------------
# Soft split / soft composition
# ---------------------------------------------------------------------------

def soft_split(ss, x, b):
    """(B*T, H, W, C) -> (B, T, f_h, f_w, hidden). Unfold + Linear as one
    stride-3 convolution: the channel-major embedding weight is an OIHW
    7x7 kernel as it stands."""
    bt, h, w, c = x.shape
    wemb = ss.embedding.weight
    kconv = wemb.reshape(wemb.shape[0], c, *T2T_KERNEL)
    tok = conv2d(x, kconv, ss.embedding.bias, stride=T2T_STRIDE,
                 padding=T2T_PADDING)
    return tok.reshape(b, bt // b, *tok.shape[1:])


def soft_comp(sc, tokens, t, output_size):
    """(B, T, f_h, f_w, hidden) -> (B*T, H, W, C): Linear, overlap-add fold,
    then the learned bias map (base, reference tfocal_transformer.py:49-72)
    or the 3x3 bias conv on the folded map (HQ, tfocal_transformer_hq.py:
    58-79)."""
    b, tt, lh, lw, hidden = tokens.shape
    patches = linear(tokens.reshape(b * t, lh * lw, hidden),
                     sc.embedding.weight, sc.embedding.bias)
    out = fold(patches.transpose(1, 2), output_size, T2T_KERNEL,
               T2T_STRIDE, T2T_PADDING)
    if hasattr(sc, "bias_conv"):
        conv = sc.bias_conv
        out = F.conv2d(out, conv.weight.to(out.dtype),
                       conv.bias.to(out.dtype), padding=1)
    else:
        out = out + sc.bias.to(out.dtype)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Static window tables (numpy copies of the JAX package's table functions)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _rolled_valid_idx(wh, ww, eh, ew):
    """Out-of-own-window positions within the 4 rolled key sets [tl, tr,
    bl, br] (reference valid_ind_rolled, tfocal_transformer.py:167-180)."""
    masks = []
    for sy, sx in ((1, 1), (1, 0), (0, 1), (0, 0)):  # tl, tr, bl, br
        m = np.ones((wh, ww), np.bool_)
        ys = slice(None, -eh) if sy else slice(eh, None)
        xs = slice(None, -ew) if sx else slice(ew, None)
        m[ys, xs] = False
        masks.append(m)
    flat = np.stack(masks, 0).reshape(-1)
    return np.nonzero(flat)[0].astype(np.int32)


@lru_cache(maxsize=32)
def _pooled_key_mask(nwh, nww, kh, kw, ph, pw):
    """-100 outside the pooled grid for the unfolded pooled keys;
    (nWin, kh*kw) float32 (reference tfocal_transformer.py:300-316)."""
    iy = np.arange(nwh)[:, None, None, None]
    ix = np.arange(nww)[None, :, None, None]
    ay = np.arange(kh)[None, None, :, None]
    ax = np.arange(kw)[None, None, None, :]
    cy = iy + ay - ph
    cx = ix + ax - pw
    valid = (cy >= 0) & (cy < nwh) & (cx >= 0) & (cx < nww)
    valid = valid.reshape(nwh * nww, kh * kw)
    return np.where(valid, 0.0, -100.0).astype(np.float32)


@lru_cache(maxsize=32)
def _rolled_rects(wh, ww, eh, ew):
    """The 4-rolled out-of-window key multiset as rectangles in window
    coordinates, ((sy, sx, y0, y1, x0, x1), ...): each roll's valid
    positions are one full-width row band and one partial column band. The
    same multiset as _rolled_valid_idx up to order; a rectangle's key at
    (y, x) is the token ((wy*wh + y - sy) mod H, (wx*ww + x - sx) mod W)."""
    rects = []
    for (sy, sx), (fy, fx) in zip(
            ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew)),
            ((1, 1), (1, 0), (0, 1), (0, 0))):
        if fy:      # the masked-out block occupies rows [0, wh-eh)
            rows_full, rows_part = (wh - eh, wh), (0, wh - eh)
        else:       # the masked-out block occupies rows [eh, wh)
            rows_full, rows_part = (0, eh), (eh, wh)
        cols_part = (ww - ew, ww) if fx else (0, ew)
        rects.append((sy, sx, rows_full[0], rows_full[1], 0, ww))
        rects.append((sy, sx, rows_part[0], rows_part[1],
                      cols_part[0], cols_part[1]))
    return tuple(r for r in rects if r[3] > r[2] and r[5] > r[4])


@lru_cache(maxsize=32)
def _key_gather_idx(h, w, wh, ww, eh, ew, pooled_geom):
    """Per-window key sources in [fine tokens (h*w) | pooled tokens |
    one zero slot]: own window, the 4-rolled out-of-window keys (torch.roll
    wrap-around by mod indexing), the unfolded pooled keys.
    Returns (idx (nwin, S) int32, n_fine)."""
    nwy, nwx = h // wh, w // ww
    vidx = _rolled_valid_idx(wh, ww, eh, ew) if (eh or ew) else None
    shifts = ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew))
    rows = []
    for wy in range(nwy):
        for wx in range(nwx):
            slots = [(wy * wh + ry) * w + (wx * ww + rx)
                     for ry in range(wh) for rx in range(ww)]
            if vidx is not None:
                for v in vidx:
                    r, rem = divmod(int(v), wh * ww)
                    ry, rx = divmod(rem, ww)
                    sy, sx = shifts[r]
                    slots.append(((wy * wh + ry - sy) % h) * w
                                 + (wx * ww + rx - sx) % w)
            rows.append(slots)
    n_fine = len(rows[0])
    if pooled_geom is not None:
        nwh, nww, pkh, pkw, ph, pw = pooled_geom
        if (nwy, nwx) != (nwh, nww):
            raise ValueError(f"window grid {(nwy, nwx)} != pooled grid "
                             f"{(nwh, nww)}")
        base = h * w
        zero_slot = base + nwh * nww
        for wy in range(nwy):
            for wx in range(nwx):
                slots = rows[wy * nwx + wx]
                for ay in range(pkh):
                    for ax in range(pkw):
                        py, px = wy + ay - ph, wx + ax - pw
                        ok = 0 <= py < nwh and 0 <= px < nww
                        slots.append(base + py * nww + px if ok
                                     else zero_slot)
    return np.asarray(rows, np.int32), n_fine


@lru_cache(maxsize=32)
def _key_gather_dedup(h, w, wh, ww, eh, ew, pooled_geom):
    """The key table without own-window slots, identical (key, bias) slots
    collapsed into one with bias + ln(count): exp(l + ln n) = n exp(l), so
    the softmax is unchanged. Padding slots read the zero slot with -1e9.
    Returns (idx (nwin, S) int32, bias (nwin, S) float32)."""
    idx, n_fine = _key_gather_idx(h, w, wh, ww, eh, ew, pooled_geom)
    wa = wh * ww
    idx = idx[:, wa:]
    n_fine -= wa
    nwh, nww, pkh, pkw, ph, pw = pooled_geom
    pm = _pooled_key_mask(nwh, nww, pkh, pkw, ph, pw)
    zero_slot = h * w + nwh * nww
    rows = []
    for wi in range(idx.shape[0]):
        slots = [(int(s), 0.0) for s in idx[wi, :n_fine]]
        slots += [(int(s), float(bb))
                  for s, bb in zip(idx[wi, n_fine:], pm[wi])]
        counts, order = {}, []
        for key in slots:
            if key not in counts:
                order.append(key)
            counts[key] = counts.get(key, 0) + 1
        rows.append([(s, b + math.log(counts[(s, b)]))
                     for (s, b) in order])
    smax = max(len(r) for r in rows)
    out_idx = np.full((len(rows), smax), zero_slot, np.int32)
    out_bias = np.full((len(rows), smax), -1e9, np.float32)
    for i, r in enumerate(rows):
        out_idx[i, :len(r)] = [s for s, _ in r]
        out_bias[i, :len(r)] = [b for _, b in r]
    return out_idx, out_bias


@lru_cache(maxsize=8)
def _window_tables(h, w, wh, ww, eh, ew, nwh, nww, t, device):
    """The windows' static key tables on `device`: (panel index, bias
    (nwin, S) float32, S).

    The panel index gives each window's key panel as rows of the per-frame
    sources [fine tokens (h*w) | pooled tokens | one zero slot] stacked
    over the t frames: the own window's tokens in the queries' (frame, y,
    x) order, then frame by frame the deduplicated rolled + pooled keys;
    (nwin * (t*wh*ww + t*S),) int64, window-major."""
    pk = (2 * (wh // 2) + 1, 2 * (ww // 2) + 1)
    geom = (nwh, nww, pk[0], pk[1], pk[0] // 2, pk[1] // 2)
    idx, bias = _key_gather_dedup(h, w, wh, ww, eh, ew, geom)
    frame = (np.arange(t) * (h * w + nwh * nww + 1))[None, :, None]
    ry, rx = np.divmod(np.arange(wh * ww), ww)
    wy, wx = np.divmod(np.arange((h // wh) * (w // ww)), w // ww)
    own = (wy[:, None] * wh + ry) * w + wx[:, None] * ww + rx
    nwin = own.shape[0]
    panel = np.concatenate([(frame + own[:, None]).reshape(nwin, -1),
                            (frame + idx[:, None]).reshape(nwin, -1)], 1)
    return (torch.as_tensor(panel.reshape(-1), dtype=torch.long,
                            device=device),
            torch.as_tensor(bias, device=device), idx.shape[1])


# ---------------------------------------------------------------------------
# Focal window attention
# ---------------------------------------------------------------------------

def window_attention(attn, x, pooled, num_heads, window_size, expand_size,
                     frame_valid=None):
    """Focal attention over temporal windows (fused formulation).

    x: (B, T, H, W, C) normalized tokens; pooled: (B, nWh, nWw, T, C)
    pooled window tokens; frame_valid: optional (B, T) bool, False on
    padding frames, whose keys are masked out. Returns (B*nWin,
    T*wh*ww, C)."""
    b, t, h, w, c = x.shape
    wh, ww = window_size
    eh, ew = expand_size
    hd = c // num_heads
    nwy, nwx = h // wh, w // ww
    nwin = nwy * nwx
    nwh, nww = pooled.shape[1], pooled.shape[2]

    qkv = linear(x, attn.qkv.weight, attn.qkv.bias)
    qkv = qkv.reshape(b, t, h, w, 3, num_heads, hd).permute(4, 0, 5, 1, 2, 3, 6)
    q, k, v = qkv[0], qkv[1], qkv[2]          # (B, heads, T, H, W, hd)
    pq = linear(pooled, attn.qkv.weight, attn.qkv.bias)
    pq = pq.reshape(b, nwh, nww, t, 3, num_heads, hd).permute(
        4, 0, 5, 3, 1, 2, 6)                  # (3, B, heads, T, nWh, nWw, hd)

    panel_idx, bias_rows, s_keys = _window_tables(h, w, wh, ww, eh, ew, nwh,
                                                  nww, t, x.device)
    nq = t * wh * ww
    nk = nq + t * s_keys

    def panel(z, zp):
        """(B*heads*nWin, nk, hd): own keys, then the gathered ones."""
        src = torch.cat([
            z.reshape(b * num_heads, t, h * w, hd),
            zp.reshape(b * num_heads, t, nwh * nww, hd),
            z.new_zeros((b * num_heads, t, 1, hd))], dim=2)
        src = src.reshape(b * num_heads, -1, hd)
        return src.index_select(1, panel_idx).reshape(-1, nk, hd)

    qw = (q * hd ** -0.5).reshape(b, num_heads, t, nwy, wh, nwx, ww, hd)
    qw = qw.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, nq, hd)

    bias_g = bias_rows[None, :, None, :].expand(b, nwin, t, s_keys)
    bias_o = torch.zeros((b, nwin, t, wh * ww), device=x.device)
    if frame_valid is not None:
        fv = frame_valid.to(x.device)[:, None, :, None]
        bias_g = torch.where(fv, bias_g, torch.full_like(bias_g, -1e9))
        bias_o = torch.where(fv, bias_o, torch.full_like(bias_o, -1e9))
    bias = torch.cat([bias_o.reshape(b, nwin, nq),
                      bias_g.reshape(b, nwin, t * s_keys)], -1)

    out = focal_attention(qw, panel(k, pq[1]), panel(v, pq[2]),
                          bias.reshape(b * nwin, nk), b, num_heads)
    return linear(out, attn.proj.weight, attn.proj.bias)


# ---------------------------------------------------------------------------
# F3N fusion feed-forward
# ---------------------------------------------------------------------------

def fusion_feed_forward(mlp, x, t, output_size):
    """x: (B, N, C) tokens. The reference's literal chain: fc1, overlap-mean
    fold to pixels, unfold back to patches, gelu, fc2
    (tfocal_transformer.py:75-101)."""
    b, n, c = x.shape
    fc1, fc2 = mlp.conv1[0], mlp.conv2[1]
    hid = linear(x, fc1.weight, fc1.bias)                  # (B, N, d_ff)
    d_ff = hid.shape[-1]
    lh, lw = token_grid(output_size)
    bt = b * (n // (lh * lw))
    p = hid.reshape(bt, lh * lw, d_ff).transpose(1, 2)
    y = fold_normalized(p, output_size, T2T_KERNEL, T2T_STRIDE, T2T_PADDING)
    y = unfold(y, T2T_KERNEL, T2T_STRIDE, T2T_PADDING)      # (BT, d_ff, L)
    y = gelu(y.transpose(1, 2).reshape(b, n, d_ff))
    return linear(y, fc2.weight, fc2.bias)


# ---------------------------------------------------------------------------
# Transformer block + stack
# ---------------------------------------------------------------------------

def _pool_level(block, x, window_size):
    """fc-pool each (wh, ww) window to one token: (B, T, H, W, C) ->
    (B, nWh, nWw, T, C). Pads or trims H, W to tile exactly (reference
    tfocal_transformer.py:478-519)."""
    b, t, h, w, c = x.shape
    wh, ww = window_size
    hp = math.ceil(h / wh) * wh
    wp = math.ceil(w / ww) * ww
    if h > hp:
        tr = (h - hp) // 2
        x = x[:, :, tr: tr + hp]
    elif h < hp:
        pt = (hp - h) // 2
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, pt, hp - h - pt))
    if w > wp:
        tr = (w - wp) // 2
        x = x[:, :, :, tr: tr + wp]
    elif w < wp:
        pl = (wp - w) // 2
        x = torch.nn.functional.pad(x, (0, 0, pl, wp - w - pl))
    nwh, nww = hp // wh, wp // ww
    xw = x.reshape(b, t, nwh, wh, nww, ww, c).float()
    pool = block.pool_layers[0]
    pw = pool.weight.reshape(wh, ww).float()
    pooled = torch.einsum("btiyjxc,yx->btijc", xw, pw) + pool.bias.float()
    return pooled.to(x.dtype).permute(0, 2, 3, 1, 4)


def _window_reverse(wins, wh, ww, b, t, h, w):
    c = wins.shape[-1]
    x = wins.reshape(b, h // wh, w // ww, t, wh, ww, c)
    return x.permute(0, 3, 1, 4, 2, 5, 6).reshape(b, t, h, w, c)


def transformer_block(block, x, output_size, num_heads=4,
                      window_size=(5, 9), frame_valid=None):
    """One temporal focal transformer block (focal level 2).
    x: (B, T, f_h, f_w, C)."""
    b, t, h, w, c = x.shape
    wh, ww = window_size
    expand = (wh // 2, ww // 2)
    xn = layer_norm(x, block.norm1.weight, block.norm1.bias)
    pooled = _pool_level(block, xn, window_size)
    attn = window_attention(block.attn, xn, pooled, num_heads, window_size,
                            expand, frame_valid=frame_valid)
    attn = attn.reshape(b * (h // wh) * (w // ww), t, wh, ww, c)
    x = x + _window_reverse(attn, wh, ww, b, t, h, w)
    y = layer_norm(x, block.norm2.weight, block.norm2.bias)
    y = fusion_feed_forward(block.mlp, y.reshape(b, t * h * w, c), t,
                            output_size)
    return x + y.reshape(b, t, h, w, c)


def transformer_stack(blocks, x, output_size, num_heads=4,
                      window_size=(5, 9), frame_valid=None, remat=False):
    """The blocks in order. remat: recompute each block in the backward
    pass (torch.utils.checkpoint), as the JAX package's training does
    (tfocal.py:846)."""
    for block in blocks:
        if remat:
            x = checkpoint(transformer_block, block, x, output_size,
                           num_heads, window_size, frame_valid,
                           use_reentrant=False)
        else:
            x = transformer_block(block, x, output_size, num_heads,
                                  window_size, frame_valid)
    return x
