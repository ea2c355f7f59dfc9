"""The reference's inference protocol (MCG-NKU/E2FGVI test.py:39-53,
146-179 and evaluate.py): mirror padding, sliding windows of local
neighbours plus strided reference frames, each window run alone at its own
length, uint8 truncation, composite, and the sequential 50/50 overlap
blend. Plain PyTorch and numpy; it imports nothing of the program.

Every frame is encoded once and every adjacent pair's flows computed once,
for all the windows that use them: the same numbers the reference's
per-window forward computes, without its repeats.
"""

import numpy as np
import torch

from reference import model as ref_model

ENC_CHUNK = 8


def neighbor_ids(f, length, stride):
    return list(range(max(0, f - stride), min(length, f + stride + 1)))


def ref_ids(f, neighbors, length, ref_length, num_ref):
    out = []
    if num_ref == -1:
        for i in range(0, length, ref_length):
            if i not in neighbors:
                out.append(i)
    else:
        start = max(0, f - ref_length * (num_ref // 2))
        end = min(length, f + ref_length * (num_ref // 2))
        for i in range(start, end + 1, ref_length):
            if i not in neighbors:
                if len(out) > num_ref:
                    break
                out.append(i)
    return out


def windows(length, stride=5, ref_length=10, num_ref=-1):
    """[(local frame ids, reference frame ids)] in pivot order."""
    out = []
    for f in range(0, length, stride):
        nb = neighbor_ids(f, length, stride)
        out.append((nb, ref_ids(f, nb, length, ref_length, num_ref)))
    return out


def mirror_pad(x, mod_h, mod_w):
    """Flip-concat (..., H, W, C) up to multiples of (mod_h, mod_w)."""
    h, w = x.shape[-3], x.shape[-2]
    hp, wp = (mod_h - h % mod_h) % mod_h, (mod_w - w % mod_w) % mod_w
    if hp:
        x = np.concatenate([x, np.flip(x, -3)], -3)[..., :h + hp, :, :]
    if wp:
        x = np.concatenate([x, np.flip(x, -2)], -2)[..., :, :w + wp, :]
    return x


@torch.no_grad()
def inpaint(g, ops, frames, masks, orig, binary, out_dtype, device,
            stride=5, ref_length=10, num_ref=-1, pad_mod=(60, 108)):
    """Composited frames of one video, as the reference's test loop makes
    them. frames (T, H, W, 3) uint8 (the model's input), masks (T, H, W, 1)
    {0, 1}, orig (T, H, W, 3) uint8, binary (T, H, W, 1) {0, 1}.
    Returns (T, H, W, 3) numpy of out_dtype (uint8 or float32)."""
    t, h, w = frames.shape[:3]
    fr = torch.from_numpy(np.ascontiguousarray(
        mirror_pad(frames, *pad_mod))).to(device)
    mk = torch.from_numpy(np.ascontiguousarray(
        mirror_pad(masks.astype(np.uint8), *pad_mod))).to(device)
    feats, smalls = [], []
    for s in range(0, t, ENC_CHUNK):
        f = fr[s: s + ENC_CHUNK].float() / 255.0 * 2.0 - 1.0
        masked = f * (1.0 - mk[s: s + ENC_CHUNK].float())
        feats.append(ref_model.encode(g, ops, masked))
        smalls.append(ref_model.resize_quarter((masked + 1.0) / 2.0))
    feat = torch.cat(feats)
    small = torch.cat(smalls)
    fwd, bwd = [], []
    for s in range(0, t - 1, ENC_CHUNK):
        b = small[s + 1: s + 1 + ENC_CHUNK]
        a = small[s: s + len(b)]
        fwd.append(ref_model.spynet(g, ops, a, b))
        bwd.append(ref_model.spynet(g, ops, b, a))
    flow_f = torch.cat(fwd) if fwd else None
    flow_b = torch.cat(bwd) if bwd else None

    orig_t = torch.from_numpy(np.ascontiguousarray(orig)).to(device)
    bm = torch.from_numpy(np.ascontiguousarray(binary[..., :1] != 0))
    bm = bm.to(device)
    comp = [None] * t
    for nb, refs in windows(t, stride, ref_length, num_ref):
        lt = len(nb)
        x = feat[nb + refs][None]
        if lt > 1:
            pairs = slice(nb[0], nb[0] + lt - 1)
            fl_b, fl_f = flow_f[pairs][None], flow_b[pairs][None]
        else:
            fl_b = fl_f = feat.new_zeros((1, 0, *feat.shape[1:3], 2))
        out = ref_model.window_forward(g, ops, x, fl_b, fl_f, lt)
        pred = ((out + 1.0) / 2.0 * 255.0).clamp(0.0, 255.0)
        pred = pred.to(torch.uint8)[:, :h, :w, :]
        for i, idx in enumerate(nb):
            img = torch.where(bm[idx], pred[i], orig_t[idx])
            if comp[idx] is None:
                comp[idx] = img
            else:
                comp[idx] = comp[idx].float() * 0.5 + img.float() * 0.5
    comp = torch.stack([c.float() for c in comp])
    if np.dtype(out_dtype) == np.uint8:
        comp = comp.to(torch.uint8)
    return comp.cpu().numpy()
