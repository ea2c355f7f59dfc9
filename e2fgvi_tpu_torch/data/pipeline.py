"""Sliding temporal-window inference (the serving path).

Counterpart of e2fgvi_tpu/data/pipeline.py; reproduces the reference
protocol (test.py:39-53,146-179 / evaluate.py:23-28,82-106): for each pivot
f (stride `neighbor_stride`) the model sees the local neighbor window plus
strided reference frames; outputs are uint8-truncated, composited as
pred*mask + original*(1-mask), and overlapping windows are blended 50/50 in
pivot order.

Window forwards are independent, so the window-independent stages run once
per unique frame or frame pair, and all windows run end-padded to one
geometry in batches of `max_batch`:

  stage 1  encode + quarter-resize, once per frame
  stage 2  SPyNet, once per adjacent pair, both directions in one batch
  stage 3  per window batch: feat_prop -> transformer -> decode
  stage 4  blend + composite on the device, one copy to the host
"""

import dataclasses
from typing import Callable

import numpy as np
import torch

from e2fgvi_tpu_torch.models import e2fgvi
from e2fgvi_tpu_torch.ops.resize import resize_scale_quarter
from e2fgvi_tpu_torch.utils import env

# H/W are mirror-padded to multiples of the base model's quarter-res
# feature grid (reference test.py:156-165); any padded size then tiles into
# whole (5, 9) attention windows, which the HQ model needs at other sizes
PAD_MOD = (60, 108)
# frames per encode call (and pairs per SPyNet call): bounds how many
# full-resolution encoder activations are live at once
ENC_CHUNK = 35


def neighbor_ids(f: int, video_length: int, stride: int = 5) -> list:
    return list(range(max(0, f - stride), min(video_length, f + stride + 1)))


def ref_ids(f: int, neighbors: list, video_length: int,
            ref_length: int = 10, num_ref: int = -1) -> list:
    """Strided reference frames (reference test.py:39-53), including its
    `len(out) > num_ref` check, which admits num_ref + 1 frames."""
    out = []
    if num_ref == -1:
        for i in range(0, video_length, ref_length):
            if i not in neighbors:
                out.append(i)
    else:
        start = max(0, f - ref_length * (num_ref // 2))
        end = min(video_length, f + ref_length * (num_ref // 2))
        for i in range(start, end + 1, ref_length):
            if i not in neighbors:
                if len(out) > num_ref:
                    break
                out.append(i)
    return out


def mirror_pad_hw(x: np.ndarray, mod_h: int = 60, mod_w: int = 108):
    """Flip-concat pad H/W up to multiples of (mod_h, mod_w) (reference
    test.py:156-165). x: (..., H, W, C). Returns (padded, (h, w))."""
    h, w = x.shape[-3], x.shape[-2]
    hp = (mod_h - h % mod_h) % mod_h
    wp = (mod_w - w % mod_w) % mod_w
    if hp:
        x = np.concatenate([x, np.flip(x, axis=-3)], axis=-3)[..., :h + hp, :, :]
    if wp:
        x = np.concatenate([x, np.flip(x, axis=-2)], axis=-2)[..., :, :w + wp, :]
    return x, (h, w)


@dataclasses.dataclass
class WindowPlan:
    pivot: int
    neighbors: list
    refs: list


def plan_windows(video_length: int, neighbor_stride: int = 5,
                 ref_length: int = 10, num_ref: int = -1) -> list:
    plans = []
    for f in range(0, video_length, neighbor_stride):
        nb = neighbor_ids(f, video_length, neighbor_stride)
        plans.append(WindowPlan(f, nb, ref_ids(f, nb, video_length,
                                               ref_length, num_ref)))
    return plans


def padding_tables(plans: list):
    """End-pad every window to one (T_pad, L) geometry (e2fgvi_tpu
    pipeline.py:425-451). Returns (n_local, idx (W, T_pad) frame ids,
    bw/fw (W, max(L-1, 1)) pair-flow ids of the backward/forward branches,
    valid (W,) real local counts, fvalid (W, T_pad) frame validity)."""
    n_local = max(len(p.neighbors) for p in plans)
    r_max = max(len(p.refs) for p in plans)
    t_pad = n_local + r_max
    idx = np.zeros((len(plans), t_pad), np.int64)
    bw = np.zeros((len(plans), max(n_local - 1, 1)), np.int64)
    fw = np.zeros_like(bw)
    valid = np.zeros((len(plans),), np.int64)
    fvalid = np.zeros((len(plans), t_pad), np.bool_)
    for wi, p in enumerate(plans):
        nv, nr = len(p.neighbors), len(p.refs)
        first = p.neighbors[0]
        idx[wi] = (p.neighbors + [p.neighbors[-1]] * (n_local - nv)
                   + p.refs + [p.refs[0] if nr else first] * (r_max - nr))
        valid[wi] = nv
        fvalid[wi, :nv] = True
        fvalid[wi, n_local: n_local + nr] = True
        last_pair = first + max(nv - 2, 0)
        s = np.arange(max(n_local - 1, 1))
        # the backward branch's steps start at the padding: shift by it
        bw[wi] = np.clip(first + s - (n_local - nv), first, last_pair)
        fw[wi] = np.clip(first + s, first, last_pair)
    return n_local, idx, bw, fw, valid, fvalid


def blend_tables(plans: list, pred_row: dict, video_length: int):
    """The reference's sequential 50/50 overlap blend as static weights:
    each new window halves the weights of the earlier ones (e2fgvi_tpu
    pipeline.py:519-543). pred_row maps (window, local index) to a row of
    the stacked predictions. Returns (idx (T, k) int64, wt (T, k) f32)."""
    contrib = [[] for _ in range(video_length)]
    for wi, p in enumerate(plans):
        for li, f in enumerate(p.neighbors):
            if not contrib[f]:
                contrib[f] = [(pred_row[(wi, li)], 1.0)]
            else:
                contrib[f] = [(r, wt * 0.5) for r, wt in contrib[f]]
                contrib[f].append((pred_row[(wi, li)], 0.5))
    kmax = max(len(c) for c in contrib)
    idx = np.zeros((video_length, kmax), np.int64)
    wt = np.zeros((video_length, kmax), np.float32)
    for f, c in enumerate(contrib):
        for j, (r, w) in enumerate(c):
            idx[f, j] = r
            wt[f, j] = w
    return idx, wt


class SlidingWindowInpainter:
    """Batched sliding-window video inpainting with cross-window reuse.

    model: an e2fgvi.Generator on `device`; dtype: the compute dtype
    (float32 or bfloat16; activations are cast to it, weights cast at each
    op unless the model already holds that dtype); out_dtype: np.float32
    (composites in [0, 255], the metric path) or np.uint8 (the
    video-writing path); pad_mod: frames are mirror-padded to multiples of
    it and the outputs cropped back."""

    def __init__(self, model, neighbor_stride: int = 5, ref_length: int = 10,
                 num_ref: int = -1, max_batch: int = 8,
                 dtype=torch.float32, out_dtype=np.float32, device=None,
                 pad_mod=PAD_MOD):
        self.device = env.device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, the inpainter "
                             f"on {self.device}")
        self.model = model
        self.neighbor_stride = neighbor_stride
        self.ref_length = ref_length
        self.num_ref = num_ref
        self.max_batch = max_batch
        self.dtype = dtype
        self.out_dtype = np.dtype(out_dtype)
        self.pad_mod = tuple(pad_mod)

    @torch.inference_mode()
    def __call__(self, frames: np.ndarray, masks: np.ndarray,
                 orig_frames: np.ndarray, binary_masks: np.ndarray,
                 progress: Callable | None = None, timer=None) -> list:
        """Inpaint a full video.

        frames: (T, H, W, 3) uint8, or float32 in [-1, 1] made from uint8;
        masks: (T, H, W, 1) {0, 1} dilated masks (the model's input);
        orig_frames: (T, H, W, 3) uint8 originals; binary_masks:
        (T, H, W, 1) {0, 1} compositing masks. timer: optional
        utils.timing.StageTimer (stages encode, flows, feat_prop,
        transformer, decode, blend). Returns T composited (H, W, 3) frames
        of out_dtype."""
        dev, dt = self.device, self.dtype
        model = self.model
        mark = timer.mark if timer is not None else None
        if timer is not None:
            timer.start()
        video_length = frames.shape[0]
        plans = plan_windows(video_length, self.neighbor_stride,
                             self.ref_length, self.num_ref)
        if frames.dtype == np.uint8:
            frames_u8 = frames
        else:
            frames_u8 = np.round((frames + 1.0) / 2.0 * 255.0).astype(np.uint8)
        frames_u8, (h, w) = mirror_pad_hw(frames_u8, *self.pad_mod)
        masks_u8, _ = mirror_pad_hw(masks.astype(np.uint8), *self.pad_mod)
        fr = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(dev)
        mk = torch.from_numpy(np.ascontiguousarray(masks_u8)).to(dev)

        # stage 1: encode once per frame (u8/255*2-1, masked, as the
        # reference's inference path normalizes)
        feats, smalls = [], []
        for s in range(0, video_length, ENC_CHUNK):
            f = fr[s: s + ENC_CHUNK].float() / 255.0 * 2.0 - 1.0
            m = mk[s: s + ENC_CHUNK].float()
            masked = (f * (1.0 - m)).to(dt)
            feats.append(model.encoder(masked))
            smalls.append(resize_scale_quarter((masked + 1.0) / 2.0))
        feat_all = torch.cat(feats, 0)
        small_all = torch.cat(smalls, 0)
        if mark:
            mark("encode")

        # stage 2: SPyNet once per adjacent pair
        n_pairs = video_length - 1
        if n_pairs == 0:
            flows_f = flows_b = small_all[..., :2].float() * 0
        else:
            ffs, fbs = [], []
            for s in range(0, n_pairs, ENC_CHUNK):
                pidx = torch.arange(s, min(s + ENC_CHUNK, n_pairs),
                                    device=dev)
                ff, fb = e2fgvi.spynet_pairs(model.update_spynet,
                                             small_all[pidx],
                                             small_all[pidx + 1])
                ffs.append(ff)
                fbs.append(fb)
            flows_f = torch.cat(ffs, 0)
            flows_b = torch.cat(fbs, 0)
        if mark:
            mark("flows")

        # stage 3: all windows end-padded to one geometry, max_batch each
        n_local, idx_all, bw_all, fw_all, val_all, fval_all = \
            padding_tables(plans)
        outs = []
        for s in range(0, len(plans), self.max_batch):
            sl = slice(s, min(s + self.max_batch, len(plans)))
            idx = torch.as_tensor(idx_all[sl], device=dev)
            b, tw = idx.shape
            feat = feat_all[idx.reshape(-1)].reshape(b, tw, *feat_all.shape[1:])
            if n_local > 1:
                ff = flows_f[torch.as_tensor(bw_all[sl], device=dev)]
                fb = flows_b[torch.as_tensor(fw_all[sl], device=dev)]
            else:
                ff = fb = flows_f.new_zeros((b, 0, *flows_f.shape[1:]))
            out = e2fgvi.window_stage(
                model, feat, (ff, fb), n_local, num_out=n_local,
                valid_local=torch.as_tensor(val_all[sl], device=dev),
                frame_valid=torch.as_tensor(fval_all[sl], device=dev),
                mark=mark)
            # the reference's (pred+1)/2*255 -> uint8 truncation
            out = ((out.float() + 1.0) / 2.0 * 255.0).clamp(0.0, 255.0)
            outs.append(out.to(torch.uint8).reshape(b * n_local,
                                                    *out.shape[2:]))
            if progress is not None:
                progress(sl.stop, len(plans))

        # stage 4: overlap blend + composite on the device, one copy back;
        # window wi's local frame li is prediction row wi * n_local + li
        pred_row = {(wi, li): wi * n_local + li
                    for wi, p in enumerate(plans)
                    for li in range(len(p.neighbors))}
        idx_np, wt_np = blend_tables(plans, pred_row, video_length)
        preds = torch.cat(outs, 0)[..., :h, :w, :]
        bidx = torch.as_tensor(idx_np, device=dev)
        bwt = torch.as_tensor(wt_np, device=dev)
        blend = (preds[bidx].float() * bwt[:, :, None, None, None]).sum(1)
        orig = torch.from_numpy(np.ascontiguousarray(orig_frames)).to(dev)
        bm = torch.from_numpy(
            np.ascontiguousarray(binary_masks[:, :h, :w, :1] != 0)).to(dev)
        if self.out_dtype == np.uint8:
            comp = torch.where(bm, blend.to(torch.uint8), orig)
        else:
            comp = torch.where(bm, blend, orig.float())
        if mark:
            mark("blend")
        comp_np = comp.cpu().numpy().astype(self.out_dtype, copy=False)
        return [comp_np[i] for i in range(video_length)]
