"""Serving traffic for Wan2.1-VACE: whole videos through the port's
`SlidingWindowInpainter.__call__` with a Wan-VACE model, one clip a
video, one client, closed loop.

The pool, its seeded order, the window (a whole number of passes that
ends after `seconds`; a traced run times one pass) and the check's sample
are serve_videos'; the frames (serve_videos' smooth noise) and each
video's mask (one moving ellipse, the tracked object a user removes) are
serve_propainter's `make_videos` (imported, not copied). The model's
weights, its two prompt embeddings (standing for umT5's outputs) and the
noise seed come from the run's seed.

`correct` compares, on the checked videos, what the timed call itself
produced with the plain reference (reference/wan_vace.py, float32, TF32
and cuDNN off):
- worst_velocity_rel: at one denoising step drawn from the seed, the
  relative L2 distance of the program's guided velocity from the
  reference's, the reference given the program's own latent at that
  step, its timestep and VACE's context as the program encoded it;
- worst_frame_mae and outside_mask_diff (harness/check.py): the
  program's composited frames against the reference's float32 VAE
  decode of the program's own final latent, composited alike.
The first call of each video the check will sample keeps these
(`keep_step`); the run reads them once the window has closed.
"""

import contextlib
import gc
import time
import traceback

import numpy as np
import torch

from e2fgvi_tpu_torch.models import wan_dit, wan_vace
from harness import check, common, peaks, trace, work_wan_vace
from harness.weights_wan_vace import make_contexts, make_state_dicts
from reference import wan_vace as ref
from reference.model import Ops

sv = common.traffic_kind("serve_videos")
pp = common.traffic_kind("serve_propainter")
pool, check_sample, log, make_videos = (sv.pool, sv.check_sample, sv.log,
                                        pp.make_videos)

STAGES = ("prep", "vae_encode", "dit", "dit_context", "vae_decode", "blend",
          "fetch")
ATTN_RANGE = "perfbench.dit_attn"


def model_config(cfg):
    """{'dit': kwargs, 'vae': kwargs} of the configuration file, as the
    port's and the reference's constructors take them."""
    dit = {k: cfg["dit"][k] for k in (
        "dim", "ffn_dim", "freq_dim", "text_dim", "text_len", "in_dim",
        "out_dim", "num_heads", "num_layers", "eps", "vace_in_dim")}
    dit["patch_size"] = tuple(cfg["dit"]["patch_size"])
    dit["vace_layers"] = tuple(cfg["dit"]["vace_layers"])
    vae = {k: cfg["vae"][k] for k in ("dim", "z_dim", "num_res_blocks")}
    vae["dim_mult"] = tuple(cfg["vae"]["dim_mult"])
    vae["temperal_downsample"] = tuple(cfg["vae"]["temperal_downsample"])
    return {"dit": dit, "vae": vae}


def prompts(cfg, seed, device):
    d = cfg["dit"]
    return make_contexts(seed, device, d["text_len"], d["text_dim"],
                         cfg["prompt_tokens"])


def check_step(cfg, seed):
    """The denoising step whose velocity the check compares."""
    return int(np.random.default_rng([seed, 2]).integers(
        cfg["sample_steps"]))


def make_model(cfg, seed, device, dtype):
    """The port's VaceWan with the seed's weights and prompts, in dtype
    (its float32 parts float32)."""
    mc = model_config(cfg)
    sds = make_state_dicts(seed, device, mc)
    with torch.device("meta"):
        model = wan_vace.build(mc, steps=cfg["sample_steps"])
    model.shift = cfg["sample_shift"]
    model.guidance = cfg["sample_guide_scale"]
    model.dit.load_state_dict(sds["dit"], strict=True, assign=True)
    model.vae.load_state_dict(sds["vae"], strict=True, assign=True)
    del sds
    model.cast(dtype).eval()
    model.set_prompts(*prompts(cfg, seed, device))
    model.seed = int(seed) % 2 ** 63
    return model


class Program:
    """The system under test: the port's Wan-VACE behind
    SlidingWindowInpainter."""

    def __init__(self, cell, seed, device):
        from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
        from e2fgvi_tpu_torch.utils import env
        env.setup()
        tr = cell["traffic"]
        dtype = getattr(torch, tr["dtype"])
        self.model = make_model(cell["config"], seed, device, dtype)
        self.inpainter = SlidingWindowInpainter(
            self.model, dtype=dtype, out_dtype=np.dtype(tr["out_dtype"]),
            device=device)

    def __call__(self, frames, masks, timer=None, keep_step=None):
        """The composited frames; keep_step: the call leaves that step's
        state for kept()."""
        self.inpainter.keep_step = keep_step
        return self.inpainter(frames, masks.astype(np.float32), frames,
                              masks, timer=timer)

    def kept(self):
        """The state the last call with keep_step left, handed over once."""
        out, self.inpainter.kept_step = self.inpainter.kept_step, None
        return out

    def stage_timer(self):
        from e2fgvi_tpu_torch.utils.timing import StageTimer
        return StageTimer()

    def kernel_ranges(self):
        """A profiler range around the DiT's self-attention where the model
        looks it up; returns the undo."""
        saved = wan_dit.self_attention

        def call(*a, **k):
            with torch.profiler.record_function(ATTN_RANGE):
                return saved(*a, **k)

        wan_dit.self_attention = call

        def undo():
            wan_dit.self_attention = saved
        return undo


def reference_models(cfg, seed, device):
    """(DiT, VAE) of the reference in float32, and the two prompts."""
    mc = model_config(cfg)
    dit, vae = ref.build(mc, make_state_dicts(seed, device, mc), device)
    return dit, vae, prompts(cfg, seed, device)


def reference_velocity(refs, cfg, kept, precision=None):
    """The reference's guided velocity at the kept latent, timestep and
    context; precision None (float32) or a float8 type's name."""
    dit, _, (c, c_null) = refs
    ops = Ops(check.ROUND_TO.get(precision))
    with check.tf32(False), torch.backends.cudnn.flags(enabled=False), \
            torch.no_grad():
        return ref.guided_velocity(ops, dit, kept["latent"],
                                   kept["timestep"], kept["context"], c,
                                   c_null, cfg["sample_guide_scale"])


def reference_frames(refs, kept, video, precision=None):
    """The reference's decode of the kept final latent, uint8, composited
    with the video's frames outside its masks (host arrays)."""
    _, vae, _ = refs
    frames, masks = video
    ops = Ops(check.ROUND_TO.get(precision))
    with check.tf32(False), torch.backends.cudnn.flags(enabled=False), \
            torch.no_grad():
        pred = ref.to_frames(ref.vae_decode(ops, vae, kept["final"]))
    h, w = frames.shape[1:3]
    return ref.composite(pred[:len(frames), :h, :w].cpu().numpy(), frames,
                         masks)


def velocity_rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def compared(readings, limits):
    """{name: {value, limit}} from [(mae, outside, velocity_rel)]."""
    out = check.compared([r[:2] for r in readings], limits)
    out["worst_velocity_rel"] = {"value": max(r[2] for r in readings),
                                 "limit": limits["worst_velocity_rel"]}
    return out


def readings(refs, cfg, video, got, kept):
    """(worst_frame_mae, outside_mask_diff, velocity_rel) of one checked
    video: the program's frames and kept state against the reference."""
    if kept is None:
        return (float("inf"),) * 3
    t0 = time.perf_counter()
    want = reference_frames(refs, kept, video)
    mae, outside = check.compare(got, want, video[1])
    t1 = time.perf_counter()
    v = reference_velocity(refs, cfg, kept)
    log(f"reference decode {t1 - t0:.1f} s, velocity "
        f"{time.perf_counter() - t1:.1f} s")
    return mae, outside, velocity_rel(kept["velocity"], v)


def run(cell, seed, seconds, traced, device, clock, program_cls=Program):
    """One run of the cell; the run record the metric readers take."""
    cfg, tr = cell["config"], cell["traffic"]
    videos = make_videos(tr, seed, device)
    plan = pool(tr, seed)
    to_check = set(check_sample(plan, range(len(plan)), seed,
                                tr["check_videos"]))
    step = check_step(cfg, seed)
    program = program_cls(cell, seed, device)
    warmed = set()
    for video in videos:        # every shape the window will meet
        if video[0].shape not in warmed:
            program(*video)
            warmed.add(video[0].shape)
    sv._sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = clock()
    log(f"set-up {setup_s:.1f} s")

    stages = dict.fromkeys(STAGES, 0.0)
    done, outputs, kept, failed, attempted = [], {}, {}, 0, 0
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
                keep = k in to_check and k not in kept
                t0 = time.perf_counter()
                try:
                    out = program(frames, masks, timer,
                                  keep_step=step if keep else None)
                except Exception:      # a failed request: counted, shown
                    traceback.print_exc()
                    failed += 1
                    break
                t1 = time.perf_counter()
                done.append((k, len(frames), t1 - t0))
                outputs.setdefault(k, out)
                if keep:
                    kept[k] = program.kept()
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
    mc = model_config(cfg)
    totals = dict.fromkeys(("model_flops", "dit_attn_flops",
                            "dit_attn_bytes"), 0)
    for _, t, _ in done:
        w = work_wan_vace.video_work(mc, t, tr["height"], tr["width"],
                                     cfg["sample_steps"], esize)
        for key in totals:
            totals[key] += w[key]
    rec = {"kind": "serve", "setup_s": setup_s, "window_s": t_end - t_start,
           "frames": sum(t for _, t, _ in done),
           "latencies": [s for _, _, s in done],
           "attempted": attempted, "failed": failed, "peak_bytes": peak,
           "peak_flops": peaks.FLOPS[tr["dtype"]],
           "peak_bytes_per_s": peaks.HBM,
           "work": totals, "stages_ms": stages if traced else None,
           "trace": (trace.summarize(events, (ATTN_RANGE,))
                     if traced and device.type == "cuda" else None)}
    log(f"trace read at {clock():.1f} s")

    sample = check_sample(plan, outputs, seed, tr["check_videos"])
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    found = []
    if sample:
        refs = reference_models(cfg, seed, device)
        for k in sample:
            got = np.stack(outputs[k])
            if got.shape != videos[k][0].shape or \
                    got.dtype != np.dtype(tr["out_dtype"]):
                found.append((float("inf"),) * 3)
                continue
            found.append(readings(refs, cfg, videos[k], got, kept.get(k)))
        del refs
    log(f"check done at {clock():.1f} s")
    rec["compared"] = compared(found or [(float("inf"),) * 3],
                               cell["check"]["limits"])
    rec["checked_lengths"] = [plan[k][0] for k in sample]
    rec["correct"] = failed == 0 and check.passes(rec["compared"])
    return rec


class ControlProgram(Program):
    """A control of the cell, driven through a run like the program: the
    program's own path, but at the checked step the velocity is the plain
    reference's at `precision` (default the cell's `check.control`) from
    the same latent, timestep and context, and the frames are the
    reference's decode at that precision of the same final latent, so
    each compared number reads the reference's loss of precision where
    the program's stood."""

    def __init__(self, cell, seed, device, precision=None):
        super().__init__(cell, seed, device)
        self.cell = cell
        self.precision = (cell["check"]["control"] if precision is None
                          else precision)
        self.refs = reference_models(cell["config"], seed, device)

    def __call__(self, frames, masks, timer=None, keep_step=None):
        out = super().__call__(frames, masks, timer, keep_step)
        kept = self.inpainter.kept_step
        if kept is None:
            return out
        kept["velocity"] = reference_velocity(self.refs, self.cell["config"],
                                              kept, self.precision)
        return list(reference_frames(self.refs, kept, (frames, masks),
                                     self.precision))
