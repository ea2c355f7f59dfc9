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

A ProPainter generator (models/propainter.py, with its RAFT as
`flow_model`) runs ProPainter's protocol (inference_propainter.py) through
the same call: RAFT once per adjacent pair in each direction on the whole
frames, image propagation per sub-video of 80 frames, the encoder once per
frame on (updated frame, mask, updated mask), then the windows as above,
each batch's sparse-attention rows made on the host from the masks and
uploaded with the video's other index tables, once a video.
"""

import dataclasses
from typing import Callable

import numpy as np
import torch

from e2fgvi_tpu_torch.models import e2fgvi, propainter, raft, tfocal
from e2fgvi_tpu_torch.ops.resize import resize_scale_quarter
from e2fgvi_tpu_torch.utils import env, timing

# H/W are mirror-padded to multiples of the base model's quarter-res
# feature grid (reference test.py:156-165); any padded size then tiles into
# whole (5, 9) attention windows, which the HQ model needs at other sizes
PAD_MOD = (60, 108)
# ProPainter's frames are multiples of 8 (RAFT's 1/8 grid)
PAD_MOD_PROPAINTER = (8, 8)
# frames per encode call (and pairs per SPyNet call): bounds how many
# full-resolution encoder activations are live at once
ENC_CHUNK = 35
# the stage that follows each of window_stage's marks within a batch
_WINDOW_NEXT = {"feat_prop": "transformer", "transformer": "decode"}


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

    model: an e2fgvi.Generator or a propainter.Generator on `device` (its
    `family` picks the protocol); flow_model: ProPainter's raft.RAFT, in
    float32 (E2FGVI's SPyNet is part of its generator); dtype: the compute
    dtype of the generator (float32 or bfloat16; activations are cast to
    it, weights cast at each op unless the model already holds that
    dtype); out_dtype: np.float32 (composites in [0, 255], the metric path)
    or np.uint8 (the video-writing path); pad_mod: frames are
    mirror-padded to multiples of it and the outputs cropped back (default
    (60, 108) for E2FGVI, (8, 8) for ProPainter). Where `keep_flows` is
    set, a ProPainter call leaves its RAFT flows, (forward, backward) on
    the device cropped to the frames, in `kept_flows`; else None."""

    def __init__(self, model, neighbor_stride: int = 5, ref_length: int = 10,
                 num_ref: int = -1, max_batch: int = 8,
                 dtype=torch.float32, out_dtype=np.float32, device=None,
                 pad_mod=None, flow_model=None):
        self.device = env.device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, the inpainter "
                             f"on {self.device}")
        self.model = model
        self.family = getattr(model, "family", "e2fgvi")
        if self.family == "propainter" and flow_model is None:
            raise ValueError("a ProPainter generator needs its RAFT "
                             "(flow_model)")
        self.flow_model = flow_model
        if pad_mod is None:
            pad_mod = (PAD_MOD_PROPAINTER if self.family == "propainter"
                       else PAD_MOD)
        self.neighbor_stride = neighbor_stride
        self.ref_length = ref_length
        self.num_ref = num_ref
        self.max_batch = max_batch
        self.dtype = dtype
        self.out_dtype = np.dtype(out_dtype)
        self.pad_mod = tuple(pad_mod)
        self.keep_flows = False
        self.kept_flows = None

    @torch.inference_mode()
    def __call__(self, frames: np.ndarray, masks: np.ndarray,
                 orig_frames: np.ndarray, binary_masks: np.ndarray,
                 progress: Callable | None = None, timer=None) -> list:
        """Inpaint a full video.

        frames: (T, H, W, 3) uint8, or float32 in [-1, 1] made from uint8;
        masks: (T, H, W, 1) {0, 1} dilated masks (the model's input);
        orig_frames: (T, H, W, 3) uint8 originals; binary_masks:
        (T, H, W, 1) {0, 1} compositing masks. timer: optional
        utils.timing.StageTimer. A timed call records the spans encode
        (from the call's start; `prep` nested in it, the host's
        preparation until frames and masks are on the device), flows,
        then feat_prop, transformer and decode for each window batch,
        blend and fetch (the copy back and the list of frames), inside
        the root range `inpaint.video`, and counts host_syncs and
        device_alloc_calls where the build has CUDA. A ProPainter call
        records flows first (RAFT, `prep` nested in it, and in it
        raft_corr and raft_update), then img_prop, encode and the rest as
        above, and counts raft_iterations, attn_rows_flagged and
        attn_rows_frame. Untimed, the call runs the same statements and
        records nothing. Returns T composited (H, W, 3) frames of
        out_dtype."""
        body = (self._inpaint_propainter if self.family == "propainter"
                else self._inpaint)
        if timer is None:
            return body(frames, masks, orig_frames, binary_masks, progress,
                        timing.NO_SPANS, None)
        with timer.video(self.device):
            return body(
                frames, masks, orig_frames, binary_masks, progress, timer,
                lambda done: timer.mark(done, _WINDOW_NEXT.get(done)))

    def _inpaint(self, frames, masks, orig_frames, binary_masks, progress,
                 spans, window_mark):
        """__call__'s body; spans: a StageTimer or timing.NO_SPANS;
        window_mark: window_stage's `mark`, None when untimed."""
        dev, dt = self.device, self.dtype
        model = self.model
        spans.begin("encode")
        spans.begin("prep")
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
        spans.end("prep")

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
        spans.mark("encode", "flows")

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
        spans.mark("flows", "feat_prop")

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
                mark=window_mark)
            spans.begin("feat_prop" if sl.stop < len(plans) else "blend")
            # the reference's (pred+1)/2*255 -> uint8 truncation
            out = ((out.float() + 1.0) / 2.0 * 255.0).clamp(0.0, 255.0)
            outs.append(out.to(torch.uint8).reshape(b * n_local,
                                                    *out.shape[2:]))
            if progress is not None:
                progress(sl.stop, len(plans))

        return self._blend_fetch(plans, n_local, outs, h, w, orig_frames,
                                 binary_masks, spans)

    def _blend_fetch(self, plans, n_local, outs, h, w, orig_frames,
                     binary_masks, spans):
        """Stage 4 (blend span open): the overlap blend and composite on
        the device, one copy back; window wi's local frame li is
        prediction row wi * n_local + li. Closes blend, records fetch."""
        dev = self.device
        video_length = orig_frames.shape[0]
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
        spans.mark("blend", "fetch")
        comp_np = comp.cpu().numpy().astype(self.out_dtype, copy=False)
        out = [comp_np[i] for i in range(video_length)]
        spans.end("fetch")
        return out

    def _inpaint_propainter(self, frames, masks, orig_frames, binary_masks,
                            progress, spans, window_mark):
        """__call__'s body for a ProPainter generator."""
        dev, dt = self.device, self.dtype
        model = self.model
        spans.begin("flows")
        spans.begin("prep")
        video_length = frames.shape[0]
        plans = plan_windows(video_length, self.neighbor_stride,
                             self.ref_length, self.num_ref)
        if frames.dtype == np.uint8:
            frames_u8 = frames
        else:
            frames_u8 = np.round((frames + 1.0) / 2.0 * 255.0).astype(np.uint8)
        frames_u8, (h, w) = mirror_pad_hw(frames_u8, *self.pad_mod)
        masks_u8, _ = mirror_pad_hw(masks.astype(np.uint8), *self.pad_mod)
        hp, wp = frames_u8.shape[1:3]
        lh, lw = tfocal.token_grid((hp // 4, wp // 4))
        n_local, tables = _propainter_tables(
            plans, masks_u8[:, ::4, ::4, 0], lh, lw, self.max_batch)
        fr = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(dev)
        mk = torch.from_numpy(np.ascontiguousarray(masks_u8)).to(dev)
        packed = torch.as_tensor(tables.pop("packed"), device=dev)
        spans.end("prep")

        # RAFT once per adjacent pair, each direction, on the whole frames
        f = fr.float() / 255.0 * 2.0 - 1.0
        if video_length > 1:
            flows_f, flows_b = raft.video_flows(self.flow_model, f,
                                                spans=spans)
        else:
            flows_f = flows_b = f.new_zeros((0, hp, wp, 2))
        self.kept_flows = ((flows_f[:, :h, :w], flows_b[:, :h, :w])
                           if self.keep_flows else None)
        spans.mark("flows", "img_prop")

        # image propagation per sub-video, on the masked frames
        m = mk.float()
        masked = f * (1.0 - m)
        updated, upd_masks = [], []
        for s, e, ks, ke in propainter.subvideo_spans(video_length):
            if e - s > 1:
                pf, pm = propainter.image_propagation(
                    masked[s:e], flows_f[s: e - 1], flows_b[s: e - 1],
                    m[s:e])
            else:
                pf, pm = masked[s:e], m[s:e]
            updated.append(pf[ks - s: ke - s])
            upd_masks.append(pm[ks - s: ke - s])
        upd = torch.cat(upd_masks)
        updated = masked + torch.cat(updated) * m
        spans.mark("img_prop", "encode")

        # the encoder once per frame; quarter-res flows once per pair
        feats = []
        for s in range(0, video_length, ENC_CHUNK):
            sl = slice(s, s + ENC_CHUNK)
            feats.append(propainter.encode(
                model, updated[sl].to(dt), m[sl].to(dt), upd[sl].to(dt)))
        feat_all = torch.cat(feats, 0)
        ds_f = propainter.downsample_flows(flows_f)
        ds_b = propainter.downsample_flows(flows_b)
        ds_m = torch.cat([m[:, ::4, ::4], upd[:, ::4, ::4]], -1).to(dt)
        spans.mark("encode", "feat_prop")

        # the windows, end-padded to one geometry, max_batch at a time
        outs = []
        for bi, s in enumerate(range(0, len(plans), self.max_batch)):
            sl = slice(s, min(s + self.max_batch, len(plans)))
            t_ = tables["batches"][bi]
            view = {k: packed[o: o + n].view(shape)
                    for k, (o, n, shape) in t_.items()}
            b, tw = view["idx"].shape
            feat = feat_all[view["idx"].reshape(-1)].reshape(
                b, tw, *feat_all.shape[1:])
            if n_local > 1:
                pairs = view["pairs"].reshape(-1)
                ff = ds_f[pairs].reshape(b, n_local - 1, *ds_f.shape[1:])
                fb = ds_b[pairs].reshape(b, n_local - 1, *ds_b.shape[1:])
            else:
                ff = fb = ds_f.new_zeros((b, 0, *ds_f.shape[1:]))
            lm = ds_m[view["idx"][:, :n_local].reshape(-1)].reshape(
                b, n_local, *ds_m.shape[1:])
            rows = propainter.SparseRows(
                view["flagged"], view["frame"],
                (view["kf0"], view["kf1"]),
                (view["kv0"].bool(), view["kv1"].bool()))

            def mark(done, rows=rows):
                if window_mark is not None:
                    window_mark(done)
                if done == "feat_prop":         # the transformer's rows
                    spans.count("attn_rows_flagged",
                                propainter.DEPTHS * rows.flagged.shape[0])
                    spans.count("attn_rows_frame",
                                propainter.DEPTHS * rows.frame.shape[0])

            out = propainter.window_stage(
                model, feat, (ff, fb), lm, n_local, rows,
                valid_local=view["valid"], mark=mark)
            spans.begin("feat_prop" if sl.stop < len(plans) else "blend")
            out = ((out.float() + 1.0) / 2.0 * 255.0).clamp(0.0, 255.0)
            outs.append(out.to(torch.uint8).reshape(b * n_local,
                                                    *out.shape[2:]))
            if progress is not None:
                progress(sl.stop, len(plans))
        return self._blend_fetch(plans, n_local, outs, h, w, orig_frames,
                                 binary_masks, spans)


def _propainter_tables(plans, masks_q, lh, lw, max_batch):
    """The index tables of every window batch of a ProPainter call, packed
    into one int64 array for one upload: frame ids, pair ids, real local
    counts, and the sparse-attention rows (propainter.SparseRows), which
    the masks decide. masks_q: (T, hq, wq) {0, 1} quarter-res (nearest)
    masks. Returns (n_local, {"packed": array, "batches": [{name:
    (offset, size, shape)}]})."""
    n_local, idx_all, _, _, val_all, _ = padding_tables(plans)
    frame_flags = propainter.window_flags(masks_q, lh, lw)
    nwin = frame_flags.shape[1]
    parts, batches, at = [], [], 0

    def put(table, name, arr):
        nonlocal at
        arr = np.asarray(arr, np.int64)
        table[name] = (at, arr.size, arr.shape)
        parts.append(arr.reshape(-1))
        at += arr.size

    for s in range(0, len(plans), max_batch):
        ps = plans[s: s + max_batch]
        table = {}
        put(table, "idx", idx_all[s: s + len(ps)])
        pairs = np.zeros((len(ps), max(n_local - 1, 1)), np.int64)
        for i, p in enumerate(ps):
            nv = len(p.neighbors)
            pairs[i] = p.neighbors[0] + np.clip(
                np.arange(pairs.shape[1]), 0, max(nv - 2, 0))
        put(table, "pairs", pairs[:, :max(n_local - 1, 0)])
        put(table, "valid", val_all[s: s + len(ps)])
        flagged, frame, kfs = [], [], ([], [])
        for i, p in enumerate(ps):
            hit = frame_flags[p.neighbors].any(0)
            for wi in range(nwin):
                row = i * nwin + wi
                if not hit[wi]:
                    frame.append(row)
                    continue
                flagged.append(row)
                for par in range(propainter.T_DILATION):
                    kfs[par].append(propainter.key_frames(
                        len(p.neighbors), len(p.refs), n_local, par))
        put(table, "flagged", flagged)
        put(table, "frame", frame)
        for par in range(propainter.T_DILATION):
            nf = max([len(k) for k in kfs[par]] + [1])
            kf = np.zeros((len(kfs[par]), nf), np.int64)
            kv = np.zeros_like(kf)
            for j, k in enumerate(kfs[par]):
                kf[j, :len(k)] = k
                kv[j, :len(k)] = 1
            put(table, f"kf{par}", kf)
            put(table, f"kv{par}", kv)
        batches.append(table)
    packed = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return n_local, {"packed": packed, "batches": batches}
