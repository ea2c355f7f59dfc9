"""Serving traffic for ProPainter: whole videos through the port's
`SlidingWindowInpainter.__call__` with a ProPainter generator and its
RAFT, one client, closed loop.

The pool, its seeded order, the window (a whole number of passes that
ends after `seconds`; a traced run times one pass) and the check's sample
are serve_videos' (imported, not copied). The videos differ: the mix's
file fixes the frame size (multiples of 8, as ProPainter resizes to), and
each video's mask is one moving ellipse, the tracked object a user
removes: semi-axes `mask.semi_axes` (x, y) pixels, moving `mask.step`
(x, y) pixels a frame and bouncing at the borders, from a start and
direction drawn from the content seed. The frames are serve_videos'
smooth noise.

`correct` compares, on the checked videos, the composited frames with the
plain reference's (reference/propainter.py: worst_frame_mae,
outside_mask_diff, as harness/check.py defines them) and the RAFT flows
of the timed path with the reference's: worst_flow_epe, the largest over
the flow fields (each pair, each direction) of a field's mean endpoint
error in pixels. The flows are those of the timed call itself: the first
call of each video the check will sample asks the inpainter to keep its
RAFT flows (`keep_flows`), and the run takes them off the device once the
window has closed.
"""

import contextlib
import gc
import time
import traceback

import numpy as np
import torch

from harness import check, common, peaks, trace, work_propainter
from harness.weights_propainter import make_state_dicts
from reference import propainter as ref

sv = common.traffic_kind("serve_videos")
pool, check_sample, log = sv.pool, sv.check_sample, sv.log

STAGES = ("flows", "img_prop", "encode", "feat_prop", "transformer",
          "decode", "blend")
K1_RANGE, K3_RANGE = sv.K1_RANGE, sv.K3_RANGE


def ellipse_masks(rng, t, h, w, semi, step):
    """(t, h, w, 1) uint8 masks of an ellipse of semi-axes `semi` (x, y)
    whose centre moves `step` (x, y) a frame, reflected at the borders;
    start and signs from the numpy Generator rng."""
    ax, ay = semi
    cx = rng.uniform(ax, w - ax)
    cy = rng.uniform(ay, h - ay)
    dx, dy = step[0] * rng.choice([-1, 1]), step[1] * rng.choice([-1, 1])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((t, h, w, 1), np.uint8)
    for i in range(t):
        out[i, ..., 0] = (((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2
                          <= 1.0)
        if not ax <= cx + dx <= w - ax:
            dx = -dx
        if not ay <= cy + dy <= h - ay:
            dy = -dy
        cx, cy = cx + dx, cy + dy
    return out


def make_videos(traffic, seed, device):
    """The pool's videos, in its order: serve_videos' frames made on
    `device`, ellipse masks from the content seed."""
    out = []
    mask = traffic["mask"]
    for t, (s, k) in pool(traffic, seed):
        state = np.random.SeedSequence([s, k]).generate_state(2, np.uint64)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state[0]))
        frames, _ = sv.synth_video(gen, t, traffic["height"],
                                   traffic["width"], device)
        masks = ellipse_masks(np.random.default_rng(int(state[1])), t,
                              traffic["height"], traffic["width"],
                              mask["semi_axes"], mask["step"])
        out.append((frames, masks))
    return out


def models(seed, device, dtype):
    """The port's ProPainter generator (in dtype) and RAFT (float32) with
    the seed's weights."""
    from e2fgvi_tpu_torch.models import propainter, raft
    sds = make_state_dicts(seed, device)
    with torch.device("meta"):
        g, r = propainter.Generator(), raft.RAFT()
    g.load_state_dict(sds["generator"], strict=True, assign=True)
    r.load_state_dict(sds["raft"], strict=True, assign=True)
    return g.to(dtype).eval(), r.float().eval()


class Program:
    """The system under test: the port's ProPainter behind
    SlidingWindowInpainter."""

    def __init__(self, cell, seed, device):
        from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
        from e2fgvi_tpu_torch.utils import env
        env.setup()
        cfg, tr = cell["config"], cell["traffic"]
        dtype = getattr(torch, tr["dtype"])
        self.model, self.raft = models(seed, device, dtype)
        self.inpainter = SlidingWindowInpainter(
            self.model, neighbor_stride=cfg["neighbor_stride"],
            ref_length=cfg["ref_stride"], num_ref=-1,
            max_batch=tr["max_batch"], dtype=dtype,
            out_dtype=np.dtype(tr["out_dtype"]), device=device,
            flow_model=self.raft)
        self.device = device

    def __call__(self, frames, masks, timer=None, keep_flows=False):
        """The composited frames; keep_flows: the call leaves its RAFT
        flows for kept_flows()."""
        self.inpainter.keep_flows = keep_flows
        return self.inpainter(frames, masks.astype(np.float32), frames,
                              masks, timer=timer)

    def kept_flows(self):
        """(flows_f, flows_b) of the last call made with keep_flows, on the
        device, handed over once."""
        flows, self.inpainter.kept_flows = self.inpainter.kept_flows, None
        return flows

    def stage_timer(self):
        from e2fgvi_tpu_torch.utils.timing import StageTimer
        return StageTimer()

    def kernel_ranges(self):
        """Profiler ranges around K1 and K3 where ProPainter's modules
        look them up; returns the undo."""
        from e2fgvi_tpu_torch.models import propainter
        saved = (propainter.modulated_deform_conv2d_head,
                 propainter.focal_attention)

        def ranged(fn, name):
            def call(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return call

        propainter.modulated_deform_conv2d_head = ranged(saved[0], K1_RANGE)
        propainter.focal_attention = ranged(saved[1], K3_RANGE)

        def undo():
            (propainter.modulated_deform_conv2d_head,
             propainter.focal_attention) = saved
        return undo


def reference_models(seed, device):
    sds = make_state_dicts(seed, device)
    g, r = ref.Generator(), ref.RAFT()
    g.load_state_dict(sds["generator"], strict=True)
    r.load_state_dict(sds["raft"], strict=True)
    return g.to(device).eval(), r.to(device).eval()


def reference_video(models_, traffic, video, device, precision=None):
    """(composite, (flows_f, flows_b) on the host) of the reference, with
    cuDNN off (PyTorch's own convolutions, independent of the program's
    cuDNN picks) and TF32 as `precision` says."""
    g, r = models_
    frames, masks = video
    with check.tf32(precision == "tf32"), \
            torch.backends.cudnn.flags(enabled=False):
        comp, flows, _ = ref.inpaint(g, r, frames, masks, frames, masks,
                                     np.dtype(traffic["out_dtype"]), device,
                                     precision)
    return comp, tuple(f.cpu() for f in flows)


def flow_epe(got, want):
    """The largest, over the fields, of a field's mean endpoint error."""
    worst = 0.0
    for a, b in zip(got, want):
        if len(a):
            epe = (a.float() - b.float()).norm(dim=-1).mean(dim=(1, 2))
            worst = max(worst, float(epe.max()))
    return worst


def compared(readings, limits):
    """{name: {value, limit}} from [(mae, outside, epe)] readings."""
    out = check.compared([r[:2] for r in readings], limits)
    out["worst_flow_epe"] = {"value": max(r[2] for r in readings),
                             "limit": limits["worst_flow_epe"]}
    return out


def run(cell, seed, seconds, traced, device, clock, program_cls=Program):
    """One run of the cell; the run record the metric readers take."""
    tr = cell["traffic"]
    videos = make_videos(tr, seed, device)
    plan = pool(tr, seed)
    # the videos the check samples once the whole pool has been served
    to_check = set(check_sample(plan, range(len(plan)), seed,
                                tr["check_videos"]))
    program = program_cls(cell, seed, device)
    for video in videos:        # every shape the window will meet
        program(*video)
    sv._sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = clock()
    log(f"set-up {setup_s:.1f} s")

    stages = dict.fromkeys(STAGES, 0.0)
    done, outputs, flows, failed, attempted = [], {}, {}, 0, 0
    undo = program.kernel_ranges() if traced else None
    profiled = trace.profile() if traced else contextlib.nullcontext([])
    with profiled as events:
        with torch.profiler.record_function(trace.WINDOW):
            t_start = time.perf_counter()
            i = 0
            while True:
                k = i % len(plan)
                i += 1
                frames, masks = videos[k]
                attempted += 1
                timer = program.stage_timer() if traced else None
                keep = k in to_check and k not in flows
                t0 = time.perf_counter()
                try:
                    out = program(frames, masks, timer, keep_flows=keep)
                except Exception:      # a failed request: counted, shown
                    traceback.print_exc()
                    failed += 1
                    break
                t1 = time.perf_counter()
                done.append((k, len(frames), t1 - t0))
                outputs.setdefault(k, out)
                if keep:
                    flows[k] = program.kept_flows()
                if timer is not None:
                    for name, ms in timer.totals().items():
                        stages[name] = stages.get(name, 0.0) + ms
                if len(done) % len(plan) == 0 and (
                        traced or t1 - t_start >= seconds):
                    break
            t_end = time.perf_counter()
    if undo:
        undo()
    log(f"window {t_end - t_start:.1f} s, {len(done)} videos")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    esize = torch.tensor([], dtype=getattr(torch, tr["dtype"])).element_size()
    totals = dict.fromkeys(("model_flops", "k1_flops", "k1_bytes",
                            "k3_flops", "k3_bytes"), 0)
    per_video = {}
    for k, t, _ in done:
        if k not in per_video:
            per_video[k] = work_propainter.video_work(
                videos[k][1], esize, tr["max_batch"])
        for key in totals:
            totals[key] += per_video[k][key]
    rec = {"kind": "serve", "setup_s": setup_s, "window_s": t_end - t_start,
           "frames": sum(t for _, t, _ in done),
           "latencies": [s for _, _, s in done],
           "attempted": attempted, "failed": failed, "peak_bytes": peak,
           "peak_flops": peaks.FLOPS[tr["dtype"]],
           "peak_bytes_per_s": peaks.HBM,
           "work": totals, "stages_ms": stages if traced else None,
           "trace": (trace.summarize(events, (K1_RANGE, K3_RANGE))
                     if traced and device.type == "cuda" else None)}
    log(f"trace read at {clock():.1f} s")

    sample = check_sample(plan, outputs, seed, tr["check_videos"])
    got_flows = {k: tuple(f.cpu() for f in flows[k]) for k in sample
                 if flows.get(k) is not None}
    del program, flows
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = []
    if sample:
        models_ = reference_models(seed, device)
        for k in sample:
            got = np.stack(outputs[k])
            want, flows = reference_video(models_, tr, videos[k], device)
            if got.shape != videos[k][0].shape or \
                    got.dtype != np.dtype(tr["out_dtype"]):
                readings.append((float("inf"),) * 3)
                continue
            mae, outside = check.compare(got, want, videos[k][1])
            epe = (flow_epe(got_flows[k], flows) if k in got_flows
                   else float("inf"))
            readings.append((mae, outside, epe))
        del models_
    log(f"check done at {clock():.1f} s")
    rec["compared"] = compared(readings or [(float("inf"),) * 3],
                               cell["check"]["limits"])
    rec["checked_lengths"] = [plan[k][0] for k in sample]
    rec["correct"] = failed == 0 and check.passes(rec["compared"])
    return rec


class ReferenceProgram:
    """The plain reference in the program's place at a precision of its
    own ('tf32' or a float8 type's name): a control of the cell, driven
    through a run like the program. Its flows are the reference's at that
    precision."""

    def __init__(self, cell, seed, device, precision=None):
        self.cell, self.device = cell, device
        self.precision = (cell["check"]["control"] if precision is None
                          else precision)
        self.models = reference_models(seed, device)
        self._kept = None

    def __call__(self, frames, masks, timer=None, keep_flows=False):
        comp, flows = reference_video(self.models, self.cell["traffic"],
                                      (frames, masks), self.device,
                                      self.precision)
        self._kept = flows if keep_flows else None
        return list(comp)

    def kept_flows(self):
        flows, self._kept = self._kept, None
        return flows

    def stage_timer(self):
        return None

    def kernel_ranges(self):
        return lambda: None
