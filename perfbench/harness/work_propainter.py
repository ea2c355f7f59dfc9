"""The work a ProPainter video needs, counted from the model's math: the
yardstick of the propainter cell's roofline and MFU metrics, in
harness/work.py's terms (operations are multiply-adds times two of every
convolution, Linear and attention product; each window at its own length
with its real frames only; a kernel's bytes are its inputs read once and
its outputs written once).

What ProPainter adds: RAFT (each frame's fnet and cnet once, the volume
and 20 update iterations a flow field, two fields a pair), the 5-channel
encoder, first-order propagation with K1 at 1152 x 128, and the sparse
transformer, whose flagged windows (the masks decide which: `flags`)
attend over the own, rolled and pooled keys of every second frame (K3),
and whose other windows attend inside each frame (SDPA, counted in the
model's operations only). RAFT's float32 operations count at the cell's
dtype's peak like the rest: the MFU is of the bfloat16 card.
"""

import numpy as np
import torch
import torch.nn.functional as F

from harness import work
from reference import model as m
from reference import propainter as p
from reference.protocol import windows

C = p.CHANNEL
HD = p.HIDDEN // p.NUM_HEADS
OWN = p.WINDOW[0] * p.WINDOW[1]
conv = work.conv


def raft_encoder_flops(h, w):
    """A BasicEncoder on an (h, w) frame, to 256 channels at 1/8."""
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    total = conv(h2, w2, 3, 64, 7) + 4 * conv(h2, w2, 64, 64, 3)
    total += conv(h4, w4, 64, 96, 3) + 3 * conv(h4, w4, 96, 96, 3) \
        + conv(h4, w4, 64, 96, 1)
    total += conv(h8, w8, 96, 128, 3) + 3 * conv(h8, w8, 128, 128, 3) \
        + conv(h8, w8, 96, 128, 1)
    return total + conv(h8, w8, 128, 256, 1)


def raft_field_flops(h, w, iters=p.RAFT_ITERS):
    """One flow field without its encoders: the volume, the iterations,
    the mask head and the convex upsampling."""
    h8, w8 = h // 8, w // 8
    n = h8 * w8
    it = (conv(h8, w8, 324, 256, 1) + conv(h8, w8, 256, 192, 3)
          + conv(h8, w8, 2, 128, 7) + conv(h8, w8, 128, 64, 3)
          + conv(h8, w8, 256, 126, 3)
          + 6 * 5 * 2 * n * 128 * 384
          + conv(h8, w8, 128, 256, 3) + conv(h8, w8, 256, 2, 3))
    head = conv(h8, w8, 128, 256, 3) + conv(h8, w8, 256, 576, 1)
    return 2 * n * n * 256 + iters * it + head + 2 * 9 * 2 * h * w


def encoder_flops(h, w):
    total = 0
    for i, (cin, cout, s, g) in enumerate(m.ENC_PLAN):
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        total += conv(h, w, 5 if i == 0 else cin, cout, 3, g)
    return total


def dcn_flops(hq, wq):
    return 2 * hq * wq * C * (C * 9)


def dcn_bytes(hq, wq, esize):
    """K1 over one frame: x (C), the offset head (27 G), the output (C),
    its flow read as both flows (two float32 pairs)."""
    return hq * wq * ((2 * C + 27 * p.DEFORM_GROUPS) * esize + 4 * 4)


def feat_prop_flops(nv, hq, wq):
    back = conv(hq, wq, 2 * C + 2, C, 3) + conv(hq, wq, C, C, 3)
    offset = (conv(hq, wq, 2 * C + 5, C, 3) + 2 * conv(hq, wq, C, C, 3)
              + conv(hq, wq, C, 27 * p.DEFORM_GROUPS, 3))
    total = 2 * (nv * back + (nv - 1) * (offset + dcn_flops(hq, wq)))
    return total + nv * (conv(hq, wq, 2 * C + 2, C, 3) + conv(hq, wq, C, C, 3))


def grids(hq, wq):
    lh, lw = ((s - 1) // 3 + 1 for s in (hq, wq))
    ph = -(-lh // p.WINDOW[0]) * p.WINDOW[0]
    pw = -(-lw // p.WINDOW[1]) * p.WINDOW[1]
    return lh, lw, ph, pw


def key_count(ph, pw):
    """Keys a flagged window takes from one key frame, duplicates of the
    rolled set collapsed: own + rolled + pooled."""
    eh, ew = ((s + 1) // 2 for s in p.WINDOW)
    wh, ww = p.WINDOW
    best = 0
    for wy in range(ph // wh):
        for wx in range(pw // ww):
            keys = {(wy * wh + y, wx * ww + x) for y in range(wh)
                    for x in range(ww)}
            for sy, sx, ys, xs in ((eh, ew, (wh - eh, wh), (ww - ew, ww)),
                                   (eh, -ew, (wh - eh, wh), (0, ew)),
                                   (-eh, ew, (0, eh), (ww - ew, ww)),
                                   (-eh, -ew, (0, eh), (0, ew))):
                for y in range(wh):
                    for x in range(ww):
                        if ys[0] <= y < ys[1] or xs[0] <= x < xs[1]:
                            keys.add(((wy * wh + y + sy) % ph,
                                      (wx * ww + x + sx) % pw))
            best = max(best, len(keys))
    return best + (ph // p.POOL[0]) * (pw // p.POOL[1])


def flags(masks):
    """(T, nwin) bool: the windows each frame's mask touches (max-pool
    7/3/3 of the nearest quarter-res mask, zero-padded to whole windows,
    window max). masks: (T, H, W, 1) {0, 1}."""
    q = torch.from_numpy(np.ascontiguousarray(
        masks[:, ::4, ::4, 0], np.float32))[:, None]
    pooled = F.max_pool2d(q, 7, 3, 3)[:, 0]
    lh, lw = pooled.shape[1:]
    _, _, ph, pw = grids(masks.shape[1] // 4, masks.shape[2] // 4)
    pooled = F.pad(pooled, (0, pw - lw, 0, ph - lh))
    wh, ww = p.WINDOW
    t = pooled.shape[0]
    win = pooled.reshape(t, ph // wh, wh, pw // ww, ww).amax((2, 4))
    return (win.reshape(t, -1) > 0).numpy()


def video_work(masks, esize, max_batch, stride=5, ref_stride=10):
    """{model_flops, k1_flops, k1_bytes, k3_flops, k3_bytes} of one video
    with masks (T, H, W, 1), in a dtype of `esize` bytes, its windows
    batched max_batch at a time."""
    length, h, w = masks.shape[:3]
    hq, wq = h // 4, w // 4
    lh, lw, ph, pw = grids(hq, wq)
    s_keys = key_count(ph, pw)
    npool = (ph // p.POOL[0]) * (pw // p.POOL[1])
    nwin = (ph // p.WINDOW[0]) * (pw // p.WINDOW[1])
    frame_flags = flags(masks)
    flops = length * (2 * raft_encoder_flops(h, w) + encoder_flops(h, w))
    flops += 2 * (length - 1) * raft_field_flops(h, w)
    k1_flops = k1_bytes = k3_flops = k3_bytes = 0
    plan = windows(length, stride, ref_stride, -1)
    hid = p.HIDDEN
    for nb, refs in plan:
        nv, t = len(nb), len(nb) + len(refs)
        nflag = int(frame_flags[nb].any(0).sum())
        flops += feat_prop_flops(nv, hq, wq)
        tok = t * lh * lw
        block = (2 * t * ph * pw * hid * 3 * hid            # q, k, v
                 + 2 * tok * hid * hid                      # proj
                 + 4 * tok * hid * p.D_FF                   # F3N
                 + 4 * p.NUM_HEADS * (nwin - nflag) * t * OWN * OWN * HD)
        attn = 0
        for i in range(p.DEPTHS):
            nk = len(range(i % 2, t, 2)) * s_keys
            attn += 4 * p.NUM_HEADS * nflag * t * OWN * nk * HD
        if nflag:
            block += 2 * t * npool * hid * (16 + 2 * hid)   # pooled k, v
            kf = len(range(0, t, 2))
            k3_bytes += p.DEPTHS * (
                2 * nflag * t * OWN * hid * esize           # q, output
                + 2 * kf * (ph * pw + npool) * hid * esize  # k, v frames
                + nflag * kf * s_keys * 4)                  # bias rows
        flops += p.DEPTHS * block + attn
        k3_flops += attn
        flops += 2 * tok * C * 49 * hid                     # soft split
        flops += 2 * nv * lh * lw * hid * C * 49 + nv * conv(hq, wq, C, C, 3)
        flops += nv * work.decode_flops(hq, wq)
        k1_flops += 2 * (nv - 1) * dcn_flops(hq, wq)
        k1_bytes += 2 * (nv - 1) * dcn_bytes(hq, wq, esize)
    weight = C * C * 9 * esize + C * 4
    for s in range(0, len(plan), max_batch):
        steps = max(len(nb) for nb, _ in plan[s: s + max_batch]) - 1
        k1_bytes += 2 * steps * weight
    return {"model_flops": flops, "k1_flops": k1_flops, "k1_bytes": k1_bytes,
            "k3_flops": k3_flops, "k3_bytes": k3_bytes}
