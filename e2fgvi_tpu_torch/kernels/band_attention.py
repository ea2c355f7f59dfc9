"""E2: band-assembled focal attention, wrapper and plain form.

Counterpart of the TPU experiment scripts/exp_attn_band_r04.py (`_kernel`
at :67, pallas_call :107, outer contract `band_attention` at :141). The
CUDA kernel is csrc/band_attention.cu.

The layer has the outer contract of the port's `tfocal.window_attention`
(qkv projection, attention, proj; returns (B*nWin, T*wh*ww, C)), but no
key gather: per frame a window's keys are the slots

    [own wh*ww | the rolled rectangles of tfocal._rolled_rects | pooled]

(S = 45 + 120 + 45 = 210 at the serving geometry), each at a static
offset from the window: own and rolled keys are tokens ((wy*wh + dy) mod H,
(wx*ww + dx) mod W), the torch.roll wrap; pooled keys are pooled cells
(wy + ay - ph, wx + ax - pw), zero keys with bias -100 outside the grid.
Every key of a frame whose `frame_valid` is False gets bias -1e9. The key
multiset is the gather path's before deduplication, so the softmax is the
same function (no ln(multiplicity) biases here).

The kernel addresses keys through `slot_tables`: per window, each slot's
source row within a frame (a token y*W + x of the qkv map, a pooled cell,
or -1 for a zero key) and its bias (0, or -100 for the zero key); key j of
a window is slot j % S of frame j // S.

`band_attention` takes the plain version for tensors on the CPU, and only
then; for other tensors it checks the kernel's inputs first (bfloat16,
head width 128, tiled geometry, frame_valid (B, T); `ValueError`, before
any CUDA call) and launches the kernel or raises. The kernel is
forward-only. `LAUNCHES` counts its launches.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.kernels.deform import check_cuda_inputs
from e2fgvi_tpu_torch.models import tfocal
from e2fgvi_tpu_torch.ops.convs import linear

LAUNCHES = {"band_attention": 0}
HEAD_DIM = 128


def _pooled_geometry(window_size):
    wh, ww = window_size
    pk = (2 * (wh // 2) + 1, 2 * (ww // 2) + 1)
    return pk, (pk[0] // 2, pk[1] // 2)


@lru_cache(maxsize=8)
def slot_offsets(wh, ww, eh, ew):
    """Per-slot (dy, dx) offsets from the window, (S, 2) int32, and the
    number of fine (own + rolled) slots before the pooled ones."""
    own = [(ry, rx) for ry in range(wh) for rx in range(ww)]
    rolled = [(y - sy, x - sx)
              for sy, sx, y0, y1, x0, x1 in tfocal._rolled_rects(wh, ww, eh,
                                                                 ew)
              for y in range(y0, y1) for x in range(x0, x1)]
    pk, pp = _pooled_geometry((wh, ww))
    pooled = [(ay - pp[0], ax - pp[1])
              for ay in range(pk[0]) for ax in range(pk[1])]
    return np.asarray(own + rolled + pooled, np.int32), len(own + rolled)


@lru_cache(maxsize=8)
def slot_tables(h, w, wh, ww, eh, ew):
    """The kernel's per-window key addressing: (src (nWin, S) int32, bias
    (nWin, S) float32, n_fine). src is the slot's source row within a
    frame: token y*w + x of the fine map for the first n_fine slots (own
    and rolled, the torch.roll wrap applied), pooled cell py*nWw + px for
    the pooled slots, -1 where the pooled cell lies outside the grid (a
    zero key); bias is 0, or -100 for those zero keys."""
    offsets, n_fine = slot_offsets(wh, ww, eh, ew)
    nwy, nwx = h // wh, w // ww
    wy, wx = np.divmod(np.arange(nwy * nwx), nwx)
    dy, dx = offsets[None, :, 0], offsets[None, :, 1]
    fine = ((wy[:, None] * wh + dy) % h) * w + (wx[:, None] * ww + dx) % w
    py, px = wy[:, None] + dy, wx[:, None] + dx
    inside = (py >= 0) & (py < nwy) & (px >= 0) & (px < nwx)
    pooled = np.where(inside, py * nwx + px, -1)
    is_fine = np.arange(len(offsets))[None, :] < n_fine
    src = np.where(is_fine, fine, pooled).astype(np.int32)
    bias = np.where(is_fine | inside, 0.0, -100.0).astype(np.float32)
    return src, bias, n_fine


@lru_cache(maxsize=8)
def _device_tables(h, w, wh, ww, eh, ew, device):
    """slot_tables on `device`: (src, the biases flattened with -1e9 (a
    key of an invalid frame) and -inf (past the keys' end) after them,
    where the kernel's producer copies a key's bias from, n_fine)."""
    src, bias, n_fine = slot_tables(h, w, wh, ww, eh, ew)
    tail = np.asarray([-1e9, -np.inf], np.float32)
    return (torch.as_tensor(src, device=device),
            torch.as_tensor(np.concatenate([bias.reshape(-1), tail]),
                            device=device), n_fine)


def _check_geometry(x, pooled, num_heads, window_size):
    b, t, h, w, c = x.shape
    wh, ww = window_size
    if h % wh or w % ww or c % num_heads:
        raise ValueError(f"band_attention: {h}x{w} tokens do not tile into "
                         f"{window_size} windows, or C={c} into {num_heads} "
                         "heads")
    if pooled.shape != (b, h // wh, w // ww, t, c):
        raise ValueError(f"band_attention: pooled {tuple(pooled.shape)} is "
                         f"not (B, nWh, nWw, T, C) for x {tuple(x.shape)}")


def band_attention_plain(attn, x, pooled, num_heads, window_size,
                         expand_size, frame_valid=None):
    """Plain version in float32: the JAX package's slice assembly
    (e2fgvi_tpu/models/tfocal.py window_attention, xla path) of each
    window's keys from the wrap-padded k/v maps and the zero-padded pooled
    maps, one batch element at a time (the logits of a whole serving batch
    are ~5 GB in float32). Returns x's dtype."""
    _check_geometry(x, pooled, num_heads, window_size)
    b, t, h, w, c = x.shape
    wh, ww = window_size
    eh, ew = expand_size
    hd = c // num_heads
    nwy, nwx = h // wh, w // ww
    nq = t * wh * ww
    pk, pp = _pooled_geometry(window_size)
    rects = tfocal._rolled_rects(wh, ww, eh, ew)
    dev = x.device
    pm = torch.as_tensor(tfocal._pooled_key_mask(nwy, nwx, *pk, *pp),
                         device=dev)                       # (nWin, 45)
    n_fine = wh * ww + sum((y1 - y0) * (x1 - x0)
                           for _, _, y0, y1, x0, x1 in rects)
    bias_win = torch.cat([torch.zeros((nwy * nwx, n_fine), device=dev), pm],
                         1)                                # (nWin, S)
    rows = torch.arange(-eh, h + eh, device=dev) % h
    cols = torch.arange(-ew, w + ew, device=dev) % w
    wq, bq = attn.qkv.weight.float(), attn.qkv.bias.float()

    def win_keys(zf, zp, wy, wx):
        """(heads, T, S, hd): own | rolled rects | pooled window."""
        oy, ox = wy * wh + eh, wx * ww + ew
        parts = [zf[:, :, oy: oy + wh, ox: ox + ww]]
        for sy, sx, y0, y1, x0, x1 in rects:
            ry = wy * wh + y0 - sy + eh
            rx = wx * ww + x0 - sx + ew
            parts.append(zf[:, :, ry: ry + y1 - y0, rx: rx + x1 - x0])
        parts.append(zp[:, :, wy: wy + pk[0], wx: wx + pk[1]])
        return torch.cat([p.reshape(num_heads, t, -1, hd) for p in parts], 2)

    outs = []
    for i in range(b):
        qkv = F.linear(x[i].float(), wq, bq).reshape(t, h, w, 3, num_heads,
                                                     hd)
        qkv = qkv.permute(3, 4, 0, 1, 2, 5)            # (3, heads, T, H, W, hd)
        pq = F.linear(pooled[i].float(), wq, bq).reshape(
            nwy, nwx, t, 3, num_heads, hd).permute(3, 4, 2, 0, 1, 5)
        kf, vf = (z[:, :, rows][:, :, :, cols] for z in (qkv[1], qkv[2]))
        kp, vp = (F.pad(z, (0, 0, pp[1], pp[1], pp[0], pp[0]))
                  for z in (pq[1], pq[2]))
        wins = [(wy, wx) for wy in range(nwy) for wx in range(nwx)]
        k = torch.stack([win_keys(kf, kp, *yx) for yx in wins])
        v = torch.stack([win_keys(vf, vp, *yx) for yx in wins])
        k = k.reshape(len(wins), num_heads, -1, hd)    # (nWin, heads, T*S, hd)
        v = v.reshape(len(wins), num_heads, -1, hd)
        q = qkv[0].reshape(num_heads, t, nwy, wh, nwx, ww, hd)
        q = q.permute(2, 4, 0, 1, 3, 5, 6).reshape(len(wins), num_heads, nq,
                                                   hd) * hd ** -0.5
        bias = bias_win[:, None, :].expand(len(wins), t, bias_win.shape[1])
        if frame_valid is not None:
            fv = frame_valid[i].to(dev)[None, :, None]
            bias = torch.where(fv, bias, torch.full_like(bias, -1e9))
        s = q @ k.transpose(-1, -2) + bias.reshape(len(wins), 1, 1, -1)
        o = torch.softmax(s, -1) @ v                    # (nWin, heads, nq, hd)
        outs.append(o.permute(0, 2, 1, 3).reshape(len(wins), nq, c))
    out = F.linear(torch.cat(outs), attn.proj.weight.float(),
                   attn.proj.bias.float())
    return out.to(x.dtype)


def check_kernel_inputs(x, pooled, num_heads, window_size,
                        frame_valid=None):
    """Raise ValueError unless the kernel takes these inputs: tiled
    geometry, bfloat16 x and pooled, head width 128, frame_valid (B, T).
    Reads shapes and dtypes only, so it runs before any CUDA call."""
    _check_geometry(x, pooled, num_heads, window_size)
    b, t = x.shape[:2]
    hd = x.shape[-1] // num_heads
    if x.dtype != torch.bfloat16 or pooled.dtype != x.dtype:
        raise ValueError(f"band_attention: the kernel takes bfloat16 x and "
                         f"pooled, got {x.dtype}, {pooled.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"band_attention: head dim {hd}, the kernel takes "
                         f"{HEAD_DIM}")
    if frame_valid is not None and tuple(frame_valid.shape) != (b, t):
        raise ValueError(f"band_attention: frame_valid "
                         f"{tuple(frame_valid.shape)} is not (B, T) = "
                         f"{(b, t)}")


def band_attention_kernel(qkv, pqkv, num_heads, window_size, expand_size,
                          frame_valid=None):
    """The E2 kernel alone: attention of each window's queries over its
    in-place keys. qkv: (B, T, H, W, 3C) and pqkv: (B, nWh, nWw, T, 3C),
    the qkv projections of the tokens and the pooled tokens, bfloat16 on
    one CUDA device. Returns (B*nWin, T*wh*ww, C), heads side by side,
    before the proj GEMM."""
    b, t, h, w, c3 = qkv.shape
    c = c3 // 3
    check_kernel_inputs(qkv[..., :c], pqkv[..., :c], num_heads, window_size,
                        frame_valid)
    wh, ww = window_size
    src, bias, n_fine = _device_tables(h, w, wh, ww, *expand_size,
                                       qkv.device)
    if frame_valid is None:
        fv = torch.ones((b, t), dtype=torch.uint8, device=qkv.device)
    else:
        fv = frame_valid.to(device=qkv.device, dtype=torch.uint8).contiguous()
    check_cuda_inputs("band_attention", qkv, pqkv, src, bias, fv)
    if any(z.data_ptr() % 16 for z in (qkv, pqkv)):
        raise ValueError("band_attention: qkv maps must be 16-byte aligned")
    nwin = (h // wh) * (w // ww)
    out = torch.empty((b * nwin, t * wh * ww, c), dtype=qkv.dtype,
                      device=qkv.device)
    err = build.library().e2fgvi_band_attention(
        qkv.data_ptr(), pqkv.data_ptr(), src.data_ptr(), bias.data_ptr(),
        fv.data_ptr(), out.data_ptr(), b, t, h, w, num_heads, wh, ww,
        pqkv.shape[1], pqkv.shape[2], src.shape[1], n_fine, HEAD_DIM,
        float(HEAD_DIM ** -0.5), *build.stream_args(qkv))
    build.check(err, "band_attention")
    LAUNCHES["band_attention"] += 1
    return out


def band_attention(attn, x, pooled, num_heads, window_size, expand_size,
                   frame_valid=None):
    """Focal window attention with in-place key reads (E2).

    x: (B, T, H, W, C) normalized tokens; pooled: (B, nWh, nWw, T, C);
    frame_valid: optional (B, T) bool. Returns (B*nWin, T*wh*ww, C).

    On the card: one GEMM makes the (B, T, H, W, 3C) qkv map and one the
    pooled (B, nWh, nWw, T, 3C) map; the kernel reads q, k and v rows from
    them in place (the 1/sqrt(hd) scale folded into q once it lands); the
    proj GEMM follows."""
    if x.device.type == "cpu":
        return band_attention_plain(attn, x, pooled, num_heads, window_size,
                                    expand_size, frame_valid)
    check_kernel_inputs(x, pooled, num_heads, window_size, frame_valid)
    qkv = linear(x, attn.qkv.weight, attn.qkv.bias).contiguous()
    pqkv = linear(pooled, attn.qkv.weight, attn.qkv.bias).contiguous()
    out = band_attention_kernel(qkv, pqkv, num_heads, window_size,
                                expand_size, frame_valid)
    return linear(out, attn.proj.weight, attn.proj.bias)
