#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one H100.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and exits nonzero):
  1. device   CUDA with compute capability 9.0; nvidia-smi name, power limit
  2. build    nvcc builds the kernels in e2fgvi_tpu_torch/csrc
  3. kernels  K1 deform_im2col, K2 flow_warp, K3 focal_attention against
              their plain PyTorch versions on the card at serving shapes
              (B=14 windows, 60x108 quarter-res), float32 and bfloat16;
              the float32 K3 (3xTF32 on tensor cores) also within max
              |delta| 1e-5 of its plain version, which one TF32 pass misses
  4. golden   the generator in float32 with the kernels against
              tests/goldens/generator_base.npz
  5. serving  SlidingWindowInpainter (bfloat16, max_batch 14) on 3
              synthetic 70-frame 432x240 videos; launch counts; one window
              batch against the float32 plain path on the CPU; then 2 more
              videos at the inpaint CLI's defaults (float32, max_batch 4),
              the second warm, with their frames/s, stage split and launch
              counts
  6. experiments  the seven kernels of the A/B experiments (E1-E6: banded
              sampler variants, row gather, 4-corner sampler,
              band-assembled attention) against their plain versions at
              the experiments' default shapes, E1/E6 bit-equal to E5; then
              the four experiment entry points
              (e2fgvi_tpu_torch.experiments) with launch counts, and E2
              against K3 on one random block
  7. hq       K1, K2 and K3 against their plain versions at the HQ model's
              shapes: 864x480 (120x216 maps; K3 on 64 windows, S=149, at
              B=2 and timed alone at B=14) and 1296x720 (K3 on 144
              windows, S=153, at B=1; K1/K2 in bfloat16 at B=14); the HQ
              generator in float32 against tests/goldens/generator_hq.npz;
              HQ serving (bfloat16, max_batch 14) on 2 synthetic 70-frame
              864x480 videos, one window batch against the float32 plain
              path on the CPU, one 20-frame 1280x720 video (mirror-padded
              to 1296x720), and one 20-frame 864x480 video at the CLI's
              defaults (float32, max_batch 4)
  8. evaluate the evaluate entry point (float32) on a synthetic DAVIS-layout
              set of 3 videos of 24 frames with a seeded I3D: PSNR/SSIM in
              range, a finite VFID from I3D on the card, the metrics file,
              launches of K1-K3; I3D on the card against the CPU
Each phase prints its seconds. The second-to-last line is the kernels JSON;
the last line is {"ok": true, "device": {...}}. Weights are the goldens'
deterministic random weights and a seeded I3D; nothing is downloaded, and
JAX is never imported.
"""

import ast
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, H, W = 14, 60, 108          # serving: windows per batch, quarter-res map
HQ_MAP = (120, 216)            # the HQ model's quarter-res map at 864x480
HQ720_MAP = (180, 324)         # ... at 1280x720, mirror-padded to 1296x720
# float32 (rtol, atol) against the plain version; bfloat16 max error
# relative to the float32 plain result's scale. The gathers are exact; the
# banded samplers and E4 sum the plain version's terms in its order; the
# bfloat16 samplers round two (E5, E1, E6) or one (cbatch) times.
# F32_MAX_ABS bounds max |delta| on top of F32_TOL where a kernel keeps
# float32 accuracy on tensor cores: K3's 3xTF32 lands ~5e-7 from float64,
# as float32 FMAs do; a single TF32 pass is ~1e-4 off.
F32_TOL = {"deform_im2col": (1e-5, 1e-4), "flow_warp": (1e-5, 1e-4),
           "focal_attention": (2e-4, 2e-4),
           "band_sample": (1e-5, 1e-5), "band_sample_cbatch": (1e-5, 1e-5),
           "row_gather": (0.0, 0.0), "bilinear4_sample": (1e-6, 1e-6)}
F32_MAX_ABS = {"focal_attention": 1e-5}
BF16_REL = {"deform_im2col": 2e-2, "flow_warp": 2e-2, "focal_attention": 5e-2,
            "band_sample": 2e-2, "band_sample_cbatch": 2e-2,
            "band_sample_xpair": 2e-2, "band_sample_cpair": 2e-2,
            "row_gather": 1e-6, "band_attention": 5e-2}
CSRC = "e2fgvi_tpu_torch/csrc/"
REPLACES = {
    "deform_im2col": (CSRC + "deform.cu",
                      "e2fgvi_tpu/kernels/dcn_band.py:158"),
    "flow_warp": (CSRC + "deform.cu", "e2fgvi_tpu/kernels/dcn_band.py:158"),
    "focal_attention": (CSRC + "focal_attention.cu",
                        "e2fgvi_tpu/kernels/fused_attention.py:57"),
    "band_sample": (CSRC + "band_sampler.cu",
                    "scripts/exp_dcn_inner_r04.py:83"),
    "band_sample_cbatch": (CSRC + "band_sampler.cu",
                           "scripts/exp_dcn_inner_r04.py:161"),
    "band_sample_xpair": (CSRC + "band_sampler.cu",
                          "scripts/exp_dcn_inner_r04.py:201"),
    "band_sample_cpair": (CSRC + "band_sampler.cu",
                          "scripts/exp_dcn_pack.py:39"),
    "row_gather": (CSRC + "gather.cu", "scripts/exp_gather.py:123"),
    "bilinear4_sample": (CSRC + "gather.cu", "scripts/exp_gather.py:171"),
    "band_attention": (CSRC + "band_attention.cu",
                       "scripts/exp_attn_band_r04.py:67"),
}


def log(msg):
    print(msg, flush=True)


def phase_end(name, t0):
    """Log the phase's seconds since t0; return the time now."""
    now = time.perf_counter()
    log(f"phase {name}: {now - t0:.1f} s")
    return now


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


def compare(name, kernel_fn, plain_fn, make_inputs, timed=True,
            dtypes=("float32", "bfloat16")):
    """kernel vs plain in float32 (tight) and bfloat16 (relative to the
    float32 plain result on the same rounded inputs), in the dtypes the
    kernel takes. ms / plain_ms are bfloat16 times where the kernel takes
    bfloat16, float32 otherwise."""
    import torch
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    res = {}
    if "float32" in dtypes:
        inputs = make_inputs(torch.float32)
        got = kernel_fn(*inputs)
        want = plain_fn(*inputs)
        rtol, atol = F32_TOL[name]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        res["max_abs_err"] = float((got - want).abs().max())
        if not res["max_abs_err"] <= F32_MAX_ABS.get(name, float("inf")):
            raise AssertionError(f"{name} f32: max |delta| "
                                 f"{res['max_abs_err']} > "
                                 f"{F32_MAX_ABS[name]}")
    if "bfloat16" in dtypes:
        inputs16 = make_inputs(torch.bfloat16)
        got16 = kernel_fn(*inputs16).float()
        want16 = plain_fn(*[t.float() if torch.is_tensor(t)
                            and t.dtype == torch.bfloat16 else t
                            for t in inputs16])
        rel = float((got16 - want16).abs().max() / want16.abs().max())
        if not rel < BF16_REL[name]:
            raise AssertionError(f"{name} bf16: rel err {rel} >= "
                                 f"{BF16_REL[name]}")
        res["bf16_rel_err"] = rel
        res.setdefault("max_abs_err", float((got16 - want16).abs().max()))
    if timed:
        main = inputs16 if "bfloat16" in dtypes else inputs
        res["ms"] = cuda_ms(lambda: kernel_fn(*main))
        res["plain_ms"] = cuda_ms(lambda: plain_fn(*main))
        if len(dtypes) == 2:
            res["ms_f32"] = cuda_ms(lambda: kernel_fn(*inputs))
            res["plain_ms_f32"] = cuda_ms(lambda: plain_fn(*inputs))
    return res


def _randn_fn(dev, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std
    return randn


def check_kernels(dev, b=B, h=H, w=W, t=17, timed=True):
    """K1, K2 and K3 against their plain versions at serving shapes."""
    res = check_k1k2(dev, b, h, w, timed)
    res["focal_attention"], _ = check_k3(dev, b, h, w, t, timed)
    return res


def check_k1k2(dev, b, h, w, timed=True, dtypes=("float32", "bfloat16")):
    """K1 and K2 against their plain versions on b quarter-res maps of
    h x w (K2's flow composition in float32 only)."""
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    randn = _randn_fn(dev)

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
        deform.deform_conv_head_plain, k1_inputs, timed, dtypes)

    # K2 at its two serving shapes: the pair of 128-channel feature warps
    # (2B maps) and the 2-channel flow composition (B maps, float32 only)
    wflow = torch.cat([flow1, flow2], 0)
    xfeat = randn(2 * b, h, w, 128)
    res["flow_warp"] = compare(
        "flow_warp", deform.flow_warp, deform.flow_warp_plain,
        lambda dt: (xfeat.to(dt), wflow), timed, dtypes)
    # the warped flow is smooth, as SPyNet's flows are: the plain form's
    # normalized grid moves samples by ~1e-5 px, which the steps of a
    # pixel-noise image would magnify past the tolerance. That shift grows
    # with the map's width (float32 spacing of the coordinates), and where
    # a sample crosses the border the zero fade's slope is the flow value
    # itself, so the bound scales with the width past the base map's
    fimg = torch.nn.functional.interpolate(
        randn(b, 2, h // 6, w // 6, std=3.0), size=(h, w), mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1).contiguous()
    torch.testing.assert_close(deform.flow_warp(fimg, flow2),
                               deform.flow_warp_plain(fimg, flow2),
                               rtol=1e-5, atol=1e-4 * max(1.0, w / W))
    return res


def k3_inputs(dev, b, h, w, t=17):
    """K3's inputs for b windows of T=t frames on the token grid of an
    h x w quarter-res map, with the real deduplicated key table and padding
    frames. Returns (make_inputs(dtype), nwin, S)."""
    import torch
    from e2fgvi_tpu_torch.models import tfocal
    randn = _randn_fn(dev)
    heads, hd, wh, ww = 4, 128, 5, 9
    fh, fw = tfocal.token_grid((h, w))
    idx, bias_rows, s = tfocal._window_tables(
        fh, fw, wh, ww, 2, 4, -(-fh // wh), -(-fw // ww), torch.device(dev))
    nwin = (fh // wh) * (fw // ww)
    nq = t * wh * ww
    fv = torch.ones((b, t), dtype=torch.bool, device=dev)
    for i, pad in enumerate((slice(6, 11), slice(9, 11), slice(15, None))):
        if i < b:
            fv[i, pad] = False
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

    def make_inputs(dt):
        return (*(v.to(dt) for v in k3_base), bias_o, bias_g, b, heads)
    return make_inputs, nwin, s


def check_k3(dev, b, h, w, t=17, timed=True):
    """K3 against its plain version (see k3_inputs). Returns compare()'s
    result and the geometry (nwin, S)."""
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    make_inputs, nwin, s = k3_inputs(dev, b, h, w, t)
    return compare("focal_attention", fa.focal_attention,
                   fa.focal_attention_plain, make_inputs, timed), (nwin, s)


SERVING_KERNELS = ("deform", "focal_attention")
SERVING_NAMES = ("deform_im2col", "flow_warp", "focal_attention")
EXPERIMENT_KERNELS = ("band_sampler", "gather", "band_attention")


def _counters(modules):
    import importlib
    return [importlib.import_module("e2fgvi_tpu_torch.kernels." + m).LAUNCHES
            for m in modules]


def launch_counts(modules=SERVING_KERNELS):
    return {k: v for d in _counters(modules) for k, v in d.items()}


def reset_launch_counts(modules=SERVING_KERNELS):
    for d in _counters(modules):
        for k in d:
            d[k] = 0


def load_golden(variant):
    return np.load(os.path.join(ROOT, "tests", "goldens",
                                f"generator_{variant}.npz"))


def golden_model(variant, dev):
    """The float32 generator of `variant` with the golden's weights."""
    from e2fgvi_tpu_torch.models import e2fgvi
    model = e2fgvi.Generator(variant)
    model.load_state_dict(golden_state_dict(load_golden(variant)),
                          strict=True)
    return model.to(dev).eval()


def check_golden(model, dev):
    """The float32 generator, kernels on, against the reference golden of
    its variant."""
    import torch
    from e2fgvi_tpu_torch.models import e2fgvi
    data = load_golden(model.variant)
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


def serve(model, dev, n_videos=3, t=70, timer_cls=None, max_batch=B,
          dtype="bfloat16", h=240, w=432):
    """The serving path: SlidingWindowInpainter on synthetic h x w videos,
    in the model's dtype."""
    import torch
    from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
    inpainter = SlidingWindowInpainter(
        model, max_batch=max_batch, dtype=getattr(torch, dtype),
        out_dtype=np.uint8, device=dev)
    videos = [synth_video(seed, t, h, w) for seed in range(1, n_videos + 1)]
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


def log_runs(label, runs):
    for i, r in enumerate(runs):
        log(f"{label} video {i}: {r['seconds']:.3f} s, "
            f"{r['fps']:.2f} frames/s, stages_ms "
            + json.dumps({k: round(v, 2) for k, v in r["stages_ms"].items()}))


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


def check_hq_kernels(dev):
    """K1, K2 and K3 against their plain versions at the HQ model's shapes.

    864x480: K1/K2 at serving batch B on 120x216 maps; K3 on the 40x72
    token grid (64 windows, S=149) at B=2, where the plain version's
    float32 logits still fit (~5 GB), and then the kernel alone at B.
    1296x720 (1280x720 mirror-padded): K3 on the 60x108 grid (144 windows,
    S=153) at B=1; K1/K2 in bfloat16 at B on 180x324 maps, where K1 writes
    its largest im2col matrix (1.88e9 elements)."""
    import torch
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    res = {}
    for label, (h, w), b3, geom in (("864x480", HQ_MAP, 2, (64, 149)),
                                    ("1296x720", HQ720_MAP, 1, (144, 153))):
        dtypes = (("float32", "bfloat16") if label == "864x480"
                  else ("bfloat16",))
        res[label] = check_k1k2(dev, B, h, w, dtypes=dtypes)
        torch.cuda.empty_cache()
        k3, (nwin, s) = check_k3(dev, b3, h, w)
        if (nwin, s) != geom:
            raise AssertionError(f"{label}: {nwin} windows, S={s}; "
                                 f"expected {geom}")
        res[label]["focal_attention"] = {"batch": b3, "nwin": nwin, "S": s,
                                         **k3}
        torch.cuda.empty_cache()
    make_inputs, _, _ = k3_inputs(dev, B, *HQ_MAP)
    for dt in ("bfloat16", "float32"):
        inputs = make_inputs(getattr(torch, dt))
        res["864x480"]["focal_attention"][f"ms_b{B}_{dt}"] = cuda_ms(
            lambda: fa.focal_attention(*inputs))
        del inputs
    return res


def write_davis(root, n_videos, t, h, w, seed=0):
    """A DAVIS-layout set under root/davis (JPEGImages/<v>.zip, per-frame
    test_masks/<v>/NNNNN.png, test.json): smooth noise frames and a moving
    rectangle mask."""
    import zipfile
    from PIL import Image
    dav = os.path.join(root, "davis")
    os.makedirs(os.path.join(dav, "JPEGImages"))
    rng = np.random.default_rng(seed)
    manifest = {}
    for v in range(n_videos):
        name = f"vid{v}"
        mask_dir = os.path.join(dav, "test_masks", name)
        os.makedirs(mask_dir)
        low = rng.integers(0, 255, (t, h // 8, w // 8, 3), dtype=np.uint8)
        with zipfile.ZipFile(os.path.join(dav, "JPEGImages", f"{name}.zip"),
                             "w") as zf:
            for i in range(t):
                jpg = os.path.join(root, f"{name}_{i}.jpg")
                Image.fromarray(low[i]).resize((w, h), Image.BILINEAR).save(
                    jpg, quality=90)
                zf.write(jpg, arcname=f"{i:05d}.jpg")
                mask = np.zeros((h, w), np.uint8)
                mask[h // 4 + 2 * i: h // 2 + 2 * i,
                     w // 4 + 3 * i: w // 2 + 3 * i] = 255
                Image.fromarray(mask).save(
                    os.path.join(mask_dir, f"{i:05d}.png"))
        manifest[name] = t
    with open(os.path.join(dav, "test.json"), "w") as f:
        json.dump(manifest, f)
    return root


def run_evaluate(dev, tmp):
    """The evaluate entry point in float32 on a synthetic DAVIS-layout set
    (3 videos of 24 frames at 432x240), the golden's base weights as a
    .pth and a seeded I3D .pt in the pytorch-i3d layout; then the I3D
    features of one video on the card against the CPU."""
    import torch
    from e2fgvi_tpu_torch.cli import evaluate
    from e2fgvi_tpu_torch.models import i3d
    write_davis(tmp, 3, 24, 240, 432)
    ckpt = os.path.join(tmp, "E2FGVI-CVPR22.pth")
    torch.save(golden_state_dict(load_golden("base")), ckpt)
    i3d_ckpt = os.path.join(tmp, "i3d_rgb_imagenet.pt")
    torch.save(i3d.random_reference_state_dict(
        torch.Generator().manual_seed(0)), i3d_ckpt)
    out = os.path.join(tmp, "results")
    reset_launch_counts()
    psnr, ssim, vfid = evaluate.main([
        "--dataset", "davis", "--data_root", tmp, "--ckpt", ckpt,
        "--i3d_ckpt", i3d_ckpt, "--device", dev, "--dtype", "float32",
        "--out", out])
    counts = launch_counts()
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"evaluate missed a kernel: {counts}")
    if not (5.0 < psnr < 60.0 and 0.0 < ssim <= 1.0 and np.isfinite(vfid)):
        raise AssertionError(f"evaluate: PSNR {psnr} SSIM {ssim} VFID {vfid}")
    with open(os.path.join(out, "e2fgvi_davis",
                           "e2fgvi_davis_metrics.txt")) as f:
        lines = f.read().splitlines()
    if len(lines) != 4 or not lines[-1].endswith(
            f"{psnr:.2f}/{ssim:.4f}/{vfid:.3f}"):
        raise AssertionError(f"metrics file: {lines}")
    video = torch.rand((1, 24, 240, 432, 3),
                       generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = i3d.i3d_features(i3d.load_i3d(i3d_ckpt, "cpu"), video)
        got = i3d.i3d_features(i3d.load_i3d(i3d_ckpt, dev),
                               video.to(dev)).cpu()
    i3d_err = float((got - want).abs().max() / want.abs().max())
    if not i3d_err <= 1e-4:
        raise AssertionError(f"I3D on the card vs the CPU: rel {i3d_err}")
    return {"psnr": psnr, "ssim": ssim, "vfid": vfid,
            "i3d_rel_err": i3d_err}, counts


def check_experiment_kernels(dev):
    """E1-E6 against their plain versions at the experiments' default
    shapes; E6 and E1 bit-equal to E5 base on the same bfloat16 source."""
    import torch
    from e2fgvi_tpu_torch.experiments import exp_attn_band_r04 as ea
    from e2fgvi_tpu_torch.experiments import exp_dcn_inner_r04 as ei
    from e2fgvi_tpu_torch.experiments import exp_dcn_pack as ep
    from e2fgvi_tpu_torch.experiments import exp_gather as eg
    from e2fgvi_tpu_torch.kernels import band_attention as ba
    from e2fgvi_tpu_torch.kernels import band_sampler as bs
    from e2fgvi_tpu_torch.kernels import gather

    res, exact = {}, {}
    src, *pos, dy_lo = ei.make_inputs(dev)          # E5/E6: band 24
    res["band_sample"] = compare(
        "band_sample", bs.band_sample, bs.band_sample_plain,
        lambda dt: (src.to(dt), *pos, dy_lo))
    res["band_sample_cbatch"] = compare(
        "band_sample_cbatch", bs.band_sample_cbatch,
        bs.band_sample_cbatch_plain, lambda dt: (src.to(dt), *pos, dy_lo))
    psrc = bs.pack_xpairs(src)
    res["band_sample_xpair"] = compare(
        "band_sample_xpair", bs.band_sample_xpair,
        lambda p, *a: bs.band_sample_plain(bs.unpack_xpairs(p).float(), *a),
        lambda dt: (psrc, *pos, dy_lo), dtypes=("bfloat16",))
    base = bs.band_sample(src, *pos, dy_lo)
    exact["E6 xpair"] = torch.equal(bs.band_sample_xpair(psrc, *pos, dy_lo),
                                    base)
    exact["E5 f32 gathers"] = torch.equal(
        bs.band_sample(src.float(), *pos, dy_lo, out_dtype=torch.bfloat16),
        base)
    del src, pos, psrc, base
    torch.cuda.empty_cache()

    src, *pos, dy_lo = ep.make_inputs(dev)          # E1: band 48
    pc = bs.pack_cpairs(src)
    res["band_sample_cpair"] = compare(
        "band_sample_cpair", bs.band_sample_cpair,
        lambda p, *a: bs.band_sample_plain(bs.unpack_cpairs(p).float(), *a),
        lambda dt: (pc, *pos, dy_lo), dtypes=("bfloat16",))
    exact["E1 cpair"] = torch.equal(bs.band_sample_cpair(pc, *pos, dy_lo),
                                    bs.band_sample(src, *pos, dy_lo))
    del src, pos, pc
    torch.cuda.empty_cache()
    if not all(exact.values()):
        raise AssertionError(f"packed samplers not bit-equal to E5: {exact}")

    tab, idx, gpy, gpx = eg.make_inputs(dev)        # E3/E4: 60x108, 9 taps
    res["row_gather"] = compare("row_gather", gather.row_gather,
                                gather.row_gather_plain,
                                lambda dt: (tab.to(dt), idx))
    res["bilinear4_sample"] = compare(
        "bilinear4_sample", gather.bilinear4_sample,
        gather.bilinear4_sample_plain, lambda dt: (tab, gpy, gpx, H, W),
        dtypes=("float32",))

    block, x, pooled = ea.make_block(dev)           # E2: B 14, T 17
    res["band_attention"] = compare(
        "band_attention", ba.band_attention, ba.band_attention_plain,
        lambda dt: (block.attn, x, pooled, ea.HEADS, ea.WIN, ea.EXP),
        dtypes=("bfloat16",))
    return res, exact


def drive_experiments():
    """The four experiment entry points, counts set to 0 just before and
    read just after; the experiments' own checks must hold."""
    from e2fgvi_tpu_torch.experiments import exp_attn_band_r04 as ea
    from e2fgvi_tpu_torch.experiments import exp_dcn_inner_r04 as ei
    from e2fgvi_tpu_torch.experiments import exp_dcn_pack as ep
    from e2fgvi_tpu_torch.experiments import exp_gather as eg
    reset_launch_counts(EXPERIMENT_KERNELS)
    out = {"exp_dcn_inner_r04": ei.main(["--iters", "3"]),
           "exp_dcn_pack": ep.main(["--iters", "3"]),
           "exp_gather": eg.main(["--iters", "3"]),
           "exp_attn_band_r04": ea.main([])}
    counts = launch_counts(EXPERIMENT_KERNELS)
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"the experiments missed a kernel: {counts}")
    if not out["exp_dcn_inner_r04"]["packed_exact"]:
        raise AssertionError("E6 packed is not bit-equal to E5 base")
    if out["exp_dcn_pack"]["max_abs_err"] != 0.0:
        raise AssertionError("E1 packed is not bit-equal to E5 current")
    gerr = {v: out["exp_gather"][v]["max_err"] for v in ("v2", "v2b", "v3")}
    if gerr["v2"] != 0.0 or gerr["v2b"] != 0.0 or not gerr["v3"] <= 1e-6:
        raise AssertionError(f"exp_gather correctness: {gerr}")
    attn = out["exp_attn_band_r04"]
    for key in ("parity_rel", "parity_fv_rel"):
        if not attn[key] < BF16_REL["focal_attention"]:
            raise AssertionError(f"E2 vs K3 {key} {attn[key]} >= "
                                 f"{BF16_REL['focal_attention']}")
    return out, counts


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, ROOT)
    from e2fgvi_tpu_torch.kernels import build
    from e2fgvi_tpu_torch.utils import env
    from e2fgvi_tpu_torch.utils.timing import StageTimer

    env.setup()
    dev = "cuda"
    t_start = time.perf_counter()
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
    t0 = phase_end("device", t_start)

    # 2. build
    _, nvcc_log = build.build()
    build.library()
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  " + line.strip())
    t0 = phase_end("build", t0)

    # 3. kernels against their plain versions
    kres = check_kernels(dev)
    for name, r in kres.items():
        log(f"kernel {name}: " + json.dumps(r))
    torch.cuda.empty_cache()
    t0 = phase_end("kernels", t0)

    # 4. golden, float32 with the kernels
    model32 = golden_model("base", dev)
    log("golden: " + json.dumps(check_golden(model32, dev)))
    t0 = phase_end("golden", t0)

    # 5. serving, bfloat16, 3 requests
    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    runs, counts, (frames, masks) = serve(model16, dev,
                                          timer_cls=StageTimer)
    log_runs("serving", runs)
    log(f"serving launches {json.dumps(counts)}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    err = window_batch_vs_plain(model32, model16, dev, frames,
                                masks.astype(np.float32), (0, 7))
    log(f"window batch bf16 kernels vs f32 plain: max |delta| {err:.4f}")
    if not err <= 0.05:
        raise AssertionError(f"bf16 window batch off by {err} > 0.05")
    # the inpaint CLI's defaults: float32, max_batch 4
    runs32, counts32, _ = serve(model32, dev, n_videos=2,
                                timer_cls=StageTimer, max_batch=4,
                                dtype="float32")
    log_runs("serving f32 max_batch 4", runs32)
    log(f"serving f32 launches {json.dumps(counts32)}")
    t0 = phase_end("serving", t0)

    # 6. the experiments' kernels and entry points
    del model16, model32
    torch.cuda.empty_cache()
    eres, exact = check_experiment_kernels(dev)
    for name, r in eres.items():
        log(f"kernel {name}: " + json.dumps(r))
    log("bit-equal to E5 base: " + json.dumps(exact))
    torch.cuda.empty_cache()
    _, ecounts = drive_experiments()
    log(f"experiments launches {json.dumps(ecounts)}")
    kres.update(eres)
    counts.update(ecounts)
    t0 = phase_end("experiments", t0)

    # 7. hq: K1-K3 at HQ shapes, the HQ golden, HQ serving at 864x480
    hres = check_hq_kernels(dev)
    for label, r in hres.items():
        for name, v in r.items():
            log(f"hq kernel {label} {name}: " + json.dumps(v))
    log(f"hq kernels: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    hq32 = golden_model("hq", dev)
    log("hq golden: " + json.dumps(check_golden(hq32, dev)))
    hq16 = copy.deepcopy(hq32).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    hruns, hcounts, (frames, masks) = serve(
        hq16, dev, n_videos=2, timer_cls=StageTimer, h=480, w=864)
    log_runs("hq serving 864x480", hruns)
    log(f"hq serving launches {json.dumps(hcounts)}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t1 = time.perf_counter()
    err = window_batch_vs_plain(hq32, hq16, dev, frames,
                                masks.astype(np.float32), (0, 13))
    log(f"hq window batch bf16 kernels vs f32 plain: max |delta| {err:.4f} "
        f"({time.perf_counter() - t1:.1f} s)")
    if not err <= 0.05:
        raise AssertionError(f"bf16 HQ window batch off by {err} > 0.05")
    # 1280x720 is no multiple of the pad: mirror-padded to 1296x720,
    # cropped back
    del frames, masks
    runs720, _, _ = serve(hq16, dev, n_videos=1, t=20, timer_cls=StageTimer,
                          h=720, w=1280)
    log_runs("hq serving 1280x720", runs720)
    del hq16
    torch.cuda.empty_cache()
    hruns32, hcounts32, _ = serve(hq32, dev, n_videos=1, t=20,
                                  timer_cls=StageTimer, max_batch=4,
                                  dtype="float32", h=480, w=864)
    log_runs("hq serving 864x480 f32 max_batch 4", hruns32)
    log(f"hq serving f32 launches {json.dumps(hcounts32)}")
    del hq32
    torch.cuda.empty_cache()
    t0 = phase_end("hq", t0)

    # 8. evaluate: the benchmark-evaluation entry point with VFID
    with tempfile.TemporaryDirectory() as tmp:
        eval_res, vcounts = run_evaluate(dev, tmp)
    log(f"evaluate: {json.dumps(eval_res)}, launches {json.dumps(vcounts)}")
    t0 = phase_end("evaluate", t0)
    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith("jax."))
    if jax_mods:
        raise AssertionError(f"JAX was imported: {jax_mods[:5]}")

    # launches: the serving runs of both models and evaluate, each read
    # just after its own run
    for c in (hcounts, vcounts):
        for name, n in c.items():
            counts[name] += n
    kernels = []
    for name, (src, replaces) in REPLACES.items():
        r = kres[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": counts[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"],
                 **{k: r[k] for k in ("ms_f32", "plain_ms_f32",
                                      "bf16_rel_err") if k in r}}
        if name in SERVING_NAMES:     # the HQ shapes' times (phase 7)
            entry["hq"] = {label: {k: v for k, v in hres[label][name].items()
                                   if k in ("ms", "plain_ms", "ms_f32",
                                            "plain_ms_f32", "max_abs_err")}
                           for label in hres}
        kernels.append(entry)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
