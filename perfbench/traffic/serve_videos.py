"""Serving traffic: whole videos through the port's
`SlidingWindowInpainter.__call__`, one client, closed loop.

The mix's file fixes the frame size, the compute dtype, max_batch, and
the pool's video lengths, a list: the DAVIS test set's (the reference's
`datasets/davis/test.json`, 50 videos of 25-104 frames) at evenly spaced
quantiles, its shortest and longest among them, the same set for every
seed. The seed orders them (a low-discrepancy order, rotated by the
seed, so that any run of consecutive videos holds short and long ones
alike) and makes each video's content. The videos are made in set-up
and handed over as host arrays, as the CLI hands frames over, and
cycled.

The window starts at the first timed call and closes at the end of the
first whole pass over the pool that ends after `seconds`, so every video
in it is whole and every seed's window holds the same work: frames/s is
all the frames completed over all the window's time. A traced run times
one whole pass instead, under the profiler.
"""

import contextlib
import gc
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from harness import check, peaks, trace, work
from harness.weights import make_state_dict

STAGES = ("encode", "flows", "feat_prop", "transformer", "decode", "blend")
K1_RANGE, K3_RANGE = "perfbench.k1", "perfbench.k3"


def synth_video(gen, t, h, w, device):
    """Smooth noise (low-res, upsampled) translating (2, 1) px per frame,
    and a moving 70 x 90 rectangle mask (chip_smoke.py's video), drawn
    from the torch.Generator `gen` on `device`; host uint8 arrays."""
    ch, cw = h + t, w + 2 * t
    low = torch.rand((1, 3, ch // 8, cw // 8), generator=gen, device=device)
    canvas = F.interpolate(low * 255.0, size=(ch, cw), mode="bilinear",
                           align_corners=False)[0]
    canvas = canvas.permute(1, 2, 0).clamp(0, 255).to(torch.uint8)
    frames = torch.stack([canvas[i: i + h, 2 * i: 2 * i + w]
                          for i in range(t)]).cpu().numpy()
    masks = np.zeros((t, h, w, 1), np.uint8)
    for i in range(t):
        y0, x0 = 40 + (2 * i) % 100, 60 + (4 * i) % 250
        masks[i, y0: y0 + 70, x0: x0 + 90] = 1
    return frames, masks


def _radical_inverse(i):
    r, f = 0.0, 0.5
    while i:
        r += f * (i & 1)
        i >>= 1
        f /= 2
    return r


def pool(traffic, seed):
    """[(length, content seed)] in the order the window cycles them."""
    ls = traffic["lengths"]
    n = len(ls)
    order = sorted(range(n), key=_radical_inverse)
    rot = seed % n
    order = order[rot:] + order[:rot]
    return [(ls[k], (seed, k)) for k in order]


def make_videos(traffic, seed, device):
    """The pool's videos, in its order, made on `device`."""
    out = []
    for t, (s, k) in pool(traffic, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.SeedSequence([s, k]).generate_state(
            1, np.uint64)[0]))
        out.append(synth_video(gen, t, traffic["height"], traffic["width"],
                               device))
    return out


class Program:
    """The system under test: the port's generator with the seed's
    weights, behind SlidingWindowInpainter."""

    def __init__(self, cell, seed, device):
        from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
        from e2fgvi_tpu_torch.models import e2fgvi
        from e2fgvi_tpu_torch.utils import env
        env.setup()
        cfg, tr = cell["config"], cell["traffic"]
        dtype = getattr(torch, tr["dtype"])
        with torch.device("meta"):
            model = e2fgvi.Generator(cfg["variant"])
        model.load_state_dict(make_state_dict(cfg["variant"], seed, device),
                              strict=True, assign=True)
        self.model = model.to(dtype).eval()
        self.inpainter = SlidingWindowInpainter(
            self.model, neighbor_stride=cfg["neighbor_stride"],
            ref_length=cfg["ref_length"], num_ref=cfg["num_ref"],
            max_batch=tr["max_batch"], dtype=dtype,
            out_dtype=np.dtype(tr["out_dtype"]), device=device)

    def __call__(self, frames, masks, timer=None):
        return self.inpainter(frames, masks.astype(np.float32), frames,
                              masks, timer=timer)

    def stage_timer(self):
        from e2fgvi_tpu_torch.utils.timing import StageTimer
        return StageTimer()

    def kernel_ranges(self):
        """Profiler ranges around K1 and K3 where the model looks them
        up; returns the undo."""
        from e2fgvi_tpu_torch.models import feat_prop, tfocal
        saved = (feat_prop.modulated_deform_conv2d_head,
                 tfocal.focal_attention)

        def ranged(fn, name):
            def call(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return call

        feat_prop.modulated_deform_conv2d_head = ranged(saved[0], K1_RANGE)
        tfocal.focal_attention = ranged(saved[1], K3_RANGE)

        def undo():
            (feat_prop.modulated_deform_conv2d_head,
             tfocal.focal_attention) = saved
        return undo


def check_sample(plan, keys, seed, n):
    """The longest of the videos `keys` (pool indices), then n - 1 more
    of them drawn from the seed."""
    ks = sorted(keys, key=lambda k: plan[k][0])
    if not ks:
        return []
    rest = ks[:-1]
    pick = np.random.default_rng([seed, 1]).choice(
        len(rest), min(n - 1, len(rest)), replace=False)
    return [ks[-1]] + [rest[j] for j in pick]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed, seconds, traced, device, clock, program_cls=Program):
    """One run of the cell. Returns the run record the metric readers
    take, with `compared` and `correct` filled by the reference check."""
    cfg, tr = cell["config"], cell["traffic"]
    videos = make_videos(tr, seed, device)
    plan = pool(tr, seed)
    program = program_cls(cell, seed, device)
    for video in videos:        # every shape the window will meet
        program(*video)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = clock()
    log(f"set-up {setup_s:.1f} s")

    stages = dict.fromkeys(STAGES, 0.0)
    done, outputs, failed, attempted = [], {}, 0, 0
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
                t0 = time.perf_counter()
                try:
                    out = program(frames, masks, timer)
                except Exception:      # a failed request: counted, shown
                    traceback.print_exc()
                    failed += 1
                    break
                t1 = time.perf_counter()
                done.append((k, len(frames), t1 - t0))
                outputs.setdefault(k, out)
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
    dt = tr["dtype"]
    esize = torch.tensor([], dtype=getattr(torch, dt)).element_size()
    totals = dict.fromkeys(("model_flops", "k1_flops", "k1_bytes",
                            "k3_flops", "k3_bytes"), 0)
    for _, t, _ in done:
        w = work.video_work(cfg["variant"], t, tr["height"], tr["width"],
                            esize, tr["max_batch"],
                            stride=cfg["neighbor_stride"],
                            ref_length=cfg["ref_length"],
                            num_ref=cfg["num_ref"])
        for key in totals:
            totals[key] += w[key]
    rec = {"kind": "serve", "setup_s": setup_s, "window_s": t_end - t_start,
           "frames": sum(t for _, t, _ in done),
           "latencies": [s for _, _, s in done],
           "attempted": attempted, "failed": failed, "peak_bytes": peak,
           "peak_flops": peaks.FLOPS[dt], "peak_bytes_per_s": peaks.HBM,
           "work": totals, "stages_ms": stages if traced else None,
           "trace": (trace.summarize(events, (K1_RANGE, K3_RANGE))
                     if traced and device.type == "cuda" else None)}
    log(f"trace read at {clock():.1f} s")
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: a sample of the window's videos, drawn from the seed,
    # with the longest in it, against the plain reference
    sample = check_sample(plan, outputs, seed, tr["check_videos"])
    readings = []
    if sample:
        g = check.reference_generator(cfg["variant"], seed, device)
        for k in sample:
            got = np.stack(outputs[k])
            if got.shape != videos[k][0].shape or \
                    got.dtype != np.dtype(tr["out_dtype"]):
                readings.append((float("inf"), float("inf")))
                continue
            want = check.reference_video(g, cfg, tr, videos[k], device)
            readings.append(check.compare(got, want, videos[k][1]))
        del g
    log(f"check done at {clock():.1f} s")
    rec["compared"] = check.compared(readings or [(float("inf"),
                                                   float("inf"))],
                                     cell["check"]["limits"])
    rec["checked_lengths"] = [plan[k][0] for k in sample]
    rec["correct"] = failed == 0 and check.passes(rec["compared"])
    return rec
