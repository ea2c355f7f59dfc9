#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one H100.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and exits nonzero):
  1. device   CUDA with compute capability 9.0; nvidia-smi name, power limit
  2. build    nvcc builds the kernels in e2fgvi_tpu_torch/csrc
  3. kernels  K1 deform_im2col, K2 flow_warp, K3 focal_attention against
              their plain PyTorch versions on the card at serving shapes
              (B=14 windows, 60x108 quarter-res), float32 and bfloat16
  4. golden   the generator in float32 with the kernels against
              tests/goldens/generator_base.npz
  5. serving  SlidingWindowInpainter (bfloat16, max_batch 14) on 3
              synthetic 70-frame 432x240 videos; launch counts; one window
              batch against the float32 plain path on the CPU
The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Weights are the golden's deterministic
random weights; nothing is downloaded.
"""

import ast
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, H, W = 14, 60, 108          # serving: windows per batch, quarter-res map
F32_TOL = {"deform_im2col": (1e-5, 1e-4), "flow_warp": (1e-5, 1e-4),
           "focal_attention": (2e-4, 2e-4)}
BF16_REL = {"deform_im2col": 2e-2, "flow_warp": 2e-2, "focal_attention": 5e-2}
REPLACES = {
    "deform_im2col": ("e2fgvi_tpu_torch/csrc/deform.cu",
                      "e2fgvi_tpu/kernels/dcn_band.py:158"),
    "flow_warp": ("e2fgvi_tpu_torch/csrc/deform.cu",
                  "e2fgvi_tpu/kernels/dcn_band.py:158"),
    "focal_attention": ("e2fgvi_tpu_torch/csrc/focal_attention.cu",
                        "e2fgvi_tpu/kernels/fused_attention.py:57"),
}


def log(msg):
    print(msg, flush=True)


def fill_weight(key, shape, rng):
    """The golden's weight rule (tests/test_generator_golden.py)."""
    if key.endswith("norm1.weight") or key.endswith("norm2.weight"):
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    if key.endswith(".bias"):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else int(shape[0])
    return (0.5 / np.sqrt(fan_in)
            * rng.standard_normal(shape)).astype(np.float32)


def golden_state_dict(data):
    import torch
    keys = [str(k) for k in data["keys"]]
    shapes = [ast.literal_eval(str(s)) for s in data["shapes"]]
    rng = np.random.default_rng(7)
    return {k: torch.from_numpy(fill_weight(k, s, rng))
            for k, s in zip(keys, shapes)}


def time_ms(fn, iters=10, warmup=2):
    """Median device time of fn() over iters runs, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(name, kernel_fn, plain_fn, make_inputs, timed=True):
    """kernel vs plain in float32 (tight) and bfloat16 (relative to the
    float32 plain result on the same rounded inputs)."""
    import torch
    inputs = make_inputs(torch.float32)
    got = kernel_fn(*inputs)
    want = plain_fn(*inputs)
    rtol, atol = F32_TOL[name]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    f32_err = float((got - want).abs().max())
    inputs16 = make_inputs(torch.bfloat16)
    got16 = kernel_fn(*inputs16).float()
    want16 = plain_fn(*[t.float() if torch.is_tensor(t)
                        and t.dtype == torch.bfloat16 else t
                        for t in inputs16])
    rel = float((got16 - want16).abs().max() / want16.abs().max())
    if not rel < BF16_REL[name]:
        raise AssertionError(f"{name} bf16: rel err {rel} >= "
                             f"{BF16_REL[name]}")
    res = {"max_abs_err": f32_err, "bf16_rel_err": rel}
    if timed:
        res["ms"] = time_ms(lambda: kernel_fn(*inputs16))
        res["plain_ms"] = time_ms(lambda: plain_fn(*inputs16))
        res["ms_f32"] = time_ms(lambda: kernel_fn(*inputs))
        res["plain_ms_f32"] = time_ms(lambda: plain_fn(*inputs))
    return res


def check_kernels(dev, b=B, h=H, w=W, t=17, timed=True):
    """K1, K2 and K3 against their plain versions at serving shapes."""
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    from e2fgvi_tpu_torch.models import tfocal

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    # random heads (std 1): offsets differ per group and tap; some flows
    # push samples far outside the image
    flow1, flow2 = randn(b, h, w, 2, std=3.0), randn(b, h, w, 2, std=3.0)
    flow1[:, :4, :, 1] -= 40.0
    flow2[:, :, -6:, 0] += 70.0
    k1_base = (randn(b, h, w, 256), randn(b, h, w, 432),
               randn(128, 256, 3, 3, std=0.02), randn(128, std=0.1))

    def k1_inputs(dt):
        x, head, wt, bias = (v.to(dt) for v in k1_base)
        return x, head, flow1, flow2, wt, bias

    res = {}
    res["deform_im2col"] = compare(
        "deform_im2col", deform.modulated_deform_conv2d_head,
        deform.deform_conv_head_plain, k1_inputs, timed)

    # K2 at its two serving shapes: the pair of 128-channel feature warps
    # (2B maps) and the 2-channel flow composition (B maps, float32 only)
    wflow = torch.cat([flow1, flow2], 0)
    xfeat = randn(2 * b, h, w, 128)
    res["flow_warp"] = compare(
        "flow_warp", deform.flow_warp, deform.flow_warp_plain,
        lambda dt: (xfeat.to(dt), wflow), timed)
    # the warped flow is smooth, as SPyNet's flows are: the plain form's
    # normalized grid moves samples by ~1e-5 px, which the steps of a
    # pixel-noise image would magnify past the tolerance
    fimg = torch.nn.functional.interpolate(
        randn(b, 2, h // 6, w // 6, std=3.0), size=(h, w), mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1).contiguous()
    torch.testing.assert_close(deform.flow_warp(fimg, flow2),
                               deform.flow_warp_plain(fimg, flow2),
                               rtol=1e-5, atol=1e-4)

    # K3 with the real deduplicated key table and padding frames
    heads, hd, wh, ww = 4, 128, 5, 9
    fh, fw = 20, 36
    idx, bias_rows, s = tfocal._window_tables(fh, fw, wh, ww, 2, 4, 4, 4,
                                              torch.device(dev))
    nwin = (fh // wh) * (fw // ww)
    nq = t * wh * ww
    fv = torch.ones((b, t), dtype=torch.bool, device=dev)
    fv[0, 6:11] = False
    fv[1, 9:11] = False
    fv[2, 15:] = False
    bias_g = bias_rows[None, :, None, :].expand(b, nwin, t, s)
    bias_g = torch.where(fv[:, None, :, None], bias_g,
                         torch.full_like(bias_g, -1e9))
    bias_g = bias_g.reshape(b * nwin, 1, t * s).contiguous()
    bias_o = torch.where(fv, 0.0, -1e9)[:, :, None].expand(b, t, wh * ww)
    bias_o = bias_o.reshape(b, 1, nq).contiguous()
    k3_base = (randn(b * heads * nwin, nq, hd, std=hd ** -0.5),
               randn(b * heads * nwin, nq, hd),
               randn(b * heads * nwin, nq, hd),
               randn(b * heads, t, nwin, s, hd),
               randn(b * heads, t, nwin, s, hd))

    def k3_inputs(dt):
        return (*(v.to(dt) for v in k3_base), bias_o, bias_g, b, heads)

    res["focal_attention"] = compare(
        "focal_attention", fa.focal_attention, fa.focal_attention_plain,
        k3_inputs, timed)
    return res


def launch_counts():
    from e2fgvi_tpu_torch.kernels import deform
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    return {**deform.LAUNCHES, **fa.LAUNCHES}


def reset_launch_counts():
    from e2fgvi_tpu_torch.kernels import deform
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    for d in (deform.LAUNCHES, fa.LAUNCHES):
        for k in d:
            d[k] = 0


def check_golden(model, dev):
    """The float32 generator, kernels on, against the reference golden."""
    import torch
    from e2fgvi_tpu_torch.models import e2fgvi
    data = np.load(os.path.join(ROOT, "tests", "goldens",
                                "generator_base.npz"))
    t, lt = int(data["t"]), int(data["lt"])
    h, w = int(data["h"]), int(data["w"])
    frames = np.random.default_rng(11).uniform(
        -1, 1, (1, t, 3, h, w)).astype(np.float32)
    x = torch.from_numpy(frames.transpose(0, 1, 3, 4, 2).copy()).to(dev)
    before = launch_counts()
    with torch.inference_mode():
        out, (ff, fb) = e2fgvi.generator_forward(model, x, lt)
    moved = {k: v - before[k] for k, v in launch_counts().items()}
    got = out.cpu().numpy().transpose(0, 3, 1, 2)[:, :, ::5, ::7]
    want = data["out_slice"]
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    if not err < 2e-3 * scale + 2e-5:
        raise AssertionError(f"golden out err {err} (scale {scale})")
    fscale = float(np.abs(data["flow_f_slice"]).max())
    ferr = 0.0
    for got_f, key in ((ff, "flow_f_slice"), (fb, "flow_b_slice")):
        gf = got_f.cpu().numpy().transpose(0, 1, 4, 2, 3)[:, :, :, ::3, ::3]
        ferr = max(ferr, float(np.abs(gf - data[key]).max()))
    if not ferr < 2e-3 * fscale + 2e-5:
        raise AssertionError(f"golden flow err {ferr} (scale {fscale})")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"golden run missed a kernel: {moved}")
    return {"out_err": err, "out_bar": 2e-3 * scale + 2e-5,
            "flow_err": ferr, "launches": moved}


def synth_video(seed, t=70, h=240, w=432):
    """Smooth noise (low-res, upsampled) translating (2, 1) px per frame,
    and a moving-rectangle mask."""
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    ch, cw = h + t, w + 2 * t
    low = rng.uniform(0, 255, (1, 3, ch // 8, cw // 8)).astype(np.float32)
    canvas = F.interpolate(torch.from_numpy(low), size=(ch, cw),
                           mode="bilinear", align_corners=False)[0]
    canvas = canvas.permute(1, 2, 0).clamp(0, 255).numpy().astype(np.uint8)
    frames = np.stack([canvas[i: i + h, 2 * i: 2 * i + w] for i in range(t)])
    masks = np.zeros((t, h, w, 1), np.uint8)
    for i in range(t):
        y0, x0 = 40 + (2 * i) % 100, 60 + (4 * i) % 250
        masks[i, y0: y0 + 70, x0: x0 + 90] = 1
    return np.ascontiguousarray(frames), masks


def serve(model16, dev, n_videos=3, t=70, timer_cls=None, max_batch=B):
    """The serving path: SlidingWindowInpainter on synthetic videos."""
    import torch
    from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
    inpainter = SlidingWindowInpainter(
        model16, max_batch=max_batch, dtype=torch.bfloat16,
        out_dtype=np.uint8, device=dev)
    videos = [synth_video(seed, t) for seed in range(1, n_videos + 1)]
    reset_launch_counts()
    runs = []
    for frames, masks in videos:
        timer = timer_cls() if timer_cls else None
        t0 = time.perf_counter()
        comp = inpainter(frames, masks.astype(np.float32), frames, masks,
                         timer=timer)
        dt = time.perf_counter() - t0
        stages = timer.totals() if timer else {}
        if len(comp) != t:
            raise AssertionError(f"{len(comp)} frames out of {t}")
        for c in comp:
            if c.shape != frames.shape[1:] or c.dtype != np.uint8:
                raise AssertionError(f"bad frame {c.shape} {c.dtype}")
        comp = np.stack(comp)
        outside = masks[..., 0] == 0
        if not np.array_equal(comp[outside], frames[outside]):
            raise AssertionError("output differs outside the mask")
        runs.append({"seconds": dt, "fps": t / dt, "stages_ms": stages})
    counts = launch_counts()
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"serving missed a kernel: {counts}")
    return runs, counts, videos[0]


def window_batch_vs_plain(model32, model16, dev, frames, masks, windows):
    """One window batch: bfloat16 kernel path on the card against the
    float32 plain path (the CPU) on the same float32 encoder features and
    flows. Returns max |delta| of the tanh output over real local frames."""
    import torch
    from e2fgvi_tpu_torch.data import pipeline
    from e2fgvi_tpu_torch.models import e2fgvi
    from e2fgvi_tpu_torch.ops.resize import resize_scale_quarter
    plans = pipeline.plan_windows(frames.shape[0])
    n_local, idx, bw, fw, valid, fvalid = pipeline.padding_tables(plans)
    sel = list(windows)
    with torch.inference_mode():
        f = torch.from_numpy(frames).to(dev).float() / 255.0 * 2.0 - 1.0
        m = torch.from_numpy(masks).to(dev).float()
        masked = f * (1.0 - m)
        feat = torch.cat([model32.encoder(masked[s: s + 35])
                          for s in range(0, len(masked), 35)])
        small = resize_scale_quarter((masked + 1.0) / 2.0)
        ff_all, fb_all = e2fgvi.spynet_pairs(model32, small[:-1], small[1:])
        feat_w = feat[torch.as_tensor(idx[sel], device=dev)]
        ff = ff_all[torch.as_tensor(bw[sel], device=dev)]
        fb = fb_all[torch.as_tensor(fw[sel], device=dev)]
        val = torch.as_tensor(valid[sel])
        fv = torch.as_tensor(fvalid[sel])
        got = e2fgvi.window_stage(
            model16, feat_w.bfloat16(), (ff, fb), n_local, num_out=n_local,
            valid_local=val.to(dev), frame_valid=fv.to(dev)).float().cpu()
        model_cpu = copy.deepcopy(model32).cpu()
        want = e2fgvi.window_stage(
            model_cpu, feat_w.cpu(), (ff.cpu(), fb.cpu()), n_local,
            num_out=n_local, valid_local=val, frame_valid=fv)
    err = 0.0
    for i, nv in enumerate(valid[sel]):
        err = max(err, float((got[i, :nv] - want[i, :nv]).abs().max()))
    return err


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, ROOT)
    from e2fgvi_tpu_torch.kernels import build
    from e2fgvi_tpu_torch.models import e2fgvi
    from e2fgvi_tpu_torch.utils import env
    from e2fgvi_tpu_torch.utils.timing import StageTimer

    env.setup()
    dev = "cuda"
    # 1. device
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 "
                         f"(Hopper), found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    _, nvcc_log = build.build()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  " + line.strip())

    # 3. kernels against their plain versions
    kres = check_kernels(dev)
    for name, r in kres.items():
        log(f"kernel {name}: " + json.dumps(r))
    torch.cuda.empty_cache()

    # 4. golden, float32 with the kernels
    data = np.load(os.path.join(ROOT, "tests", "goldens",
                                "generator_base.npz"))
    model32 = e2fgvi.Generator()
    model32.load_state_dict(golden_state_dict(data), strict=True)
    model32 = model32.to(dev).eval()
    log("golden: " + json.dumps(check_golden(model32, dev)))

    # 5. serving, bfloat16, 3 requests
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    runs, counts, (frames, masks) = serve(model16, dev,
                                          timer_cls=StageTimer)
    for i, r in enumerate(runs):
        log(f"serving video {i}: {r['seconds']:.3f} s, "
            f"{r['fps']:.2f} frames/s, stages_ms "
            + json.dumps({k: round(v, 2) for k, v in r["stages_ms"].items()}))
    log(f"serving launches {json.dumps(counts)}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    err = window_batch_vs_plain(model32, model16, dev, frames,
                                masks.astype(np.float32), (0, 7))
    log(f"window batch bf16 kernels vs f32 plain: max |delta| {err:.4f}")
    if not err <= 0.05:
        raise AssertionError(f"bf16 window batch off by {err} > 0.05")

    kernels = []
    for name, (src, replaces) in REPLACES.items():
        r = kres[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bf16_rel_err": r["bf16_rel_err"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
