#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, evaluation and training paths
on one H100.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and exits nonzero):
  1. device   CUDA with compute capability 9.0; nvidia-smi name, power limit
  2. build    nvcc builds the kernels in e2fgvi_tpu_torch/csrc; the SASS
              of the bf16 K3 and of K1 in both dtypes (one fused kernel
              each) must hold HGMMA (wgmma; TF32 ones in the float32 K1)
              and UTMALDG (TMA loads)
  3. kernels  K1 deform_conv, K2 flow_warp, K3 focal_attention against
              their plain PyTorch versions on the card at serving shapes
              (B=14 windows, 60x108 quarter-res), float32 and bfloat16;
              K1 also with gemm_ms (cuBLAS on a random M x 2304 im2col
              matrix, the contraction alone as a yardstick) and the peak
              device memory of one call;
              the float32 K1 and K3 (3xTF32 on tensor cores) also within
              max |delta| 2e-5 and 1e-5 of their plain versions, which one
              TF32 pass misses (K1's one-pass error is recorded beside
              it); both float32 kernels' bound at the 3xTF32 rate, their
              FP32-rate bound beside it;
              K3 also at B=1 with only the first frame valid.
              Beside each kernel's ms: its plain version's, the one
              PyTorch call that computes the same function where there is
              one (library_ms: F.grid_sample for K2,
              scaled_dot_product_attention for K3), and its bound
              (bound_ms: bytes at 3.35 TB/s against operations at the
              H100 SXM's peak for their type)
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
              the experiments' default shapes, E1/E6 bit-equal to E5, with
              bounds and library calls (torch.gather for E3, F.grid_sample
              for E4); then
              the four experiment entry points
              (e2fgvi_tpu_torch.experiments) with launch counts, and E2
              against K3 on one random block
  7. hq       K1, K2 and K3 against their plain versions at the HQ model's
              shapes: 864x480 (120x216 maps; K3 on 64 windows, S=149, at
              B=2, at B=14, there against the plain version one batch
              element at a time, and at B=1 with only the first frame
              valid) and 1296x720 (K3 on 144
              windows, S=153, at B=1; K1 at B=14, K2 in bfloat16); the HQ
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
  9. train    the Trainer (e2fgvi_tpu_torch.train.trainer) on
              configs/train_e2fgvi.json at its batch 8 (4 where 8 runs out
              of memory, logged) on a synthetic YouTube-VOS-layout set of
              8 videos of 20 frames at 432x240: 4 steps (float32, remat),
              saving at step 2, with each step's seconds (CUDA events),
              peak memory, finite losses, K1-K3 launches forward and in
              remat, parameters moved and the frozen SPyNet not; a fresh
              Trainer restored at step 2 runs step 3 again (cuDNN
              deterministic for both): equal losses, parameters within two
              Adam steps; one step at b=1 on the card against the CPU's
              plain path (losses and every gradient); one step of
              configs/train_e2fgvi_hq.json at batch 2
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
# training (phase 9): steps of the base config, and its synthetic set: 8
# videos of 20 frames, so that the config's batch of 8 is one whole batch
TRAIN_STEPS, TRAIN_VIDEOS = 4, 8
HQ_MAP = (120, 216)            # the HQ model's quarter-res map at 864x480
HQ720_MAP = (180, 324)         # ... at 1280x720, mirror-padded to 1296x720
# float32 (rtol, atol) against the plain version; bfloat16 max error
# relative to the float32 plain result's scale. The gathers are exact; the
# banded samplers and E4 sum the plain version's terms in its order; the
# bfloat16 samplers round two (E5, E1, E6) or one (cbatch) times.
# F32_MAX_ABS bounds max |delta| on top of F32_TOL where a kernel keeps
# float32 accuracy on tensor cores: K3's 3xTF32 lands ~5e-7 from float64,
# as float32 FMAs do; a single TF32 pass is ~1e-4 off in K3, ~6e-4 in K1.
# K1's plain version samples at the kernel's float32 pixel positions: the
# f32 K1 reads 6.6e-6 (base) and 1.0e-5 (864x480) from it, 2.0e-5 at 324
# columns, where its 3xTF32 contraction over a wider map is held to
# F32_TOL only (phase 7).
F32_TOL = {"deform_conv": (1e-5, 1e-4), "flow_warp": (1e-5, 1e-4),
           "focal_attention": (2e-4, 2e-4),
           "band_sample": (1e-5, 1e-5), "band_sample_cbatch": (1e-5, 1e-5),
           "row_gather": (0.0, 0.0), "bilinear4_sample": (1e-6, 1e-6)}
F32_MAX_ABS = {"deform_conv": 2e-5, "focal_attention": 1e-5}
BF16_REL = {"deform_conv": 2e-2, "flow_warp": 2e-2, "focal_attention": 5e-2,
            "band_sample": 2e-2, "band_sample_cbatch": 2e-2,
            "band_sample_xpair": 2e-2, "band_sample_cpair": 2e-2,
            "row_gather": 1e-6, "band_attention": 5e-2}
# the bound: an H100 SXM's published dense peaks (bf16 and TF32 on the
# tensor cores, float32 without them) and its memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
CSRC = "e2fgvi_tpu_torch/csrc/"
REPLACES = {
    "deform_conv": (CSRC + "deform.cu",
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


def sass_histograms(lib, kernels):
    """{kernel: Counter of SASS opcodes with their modifiers} of the
    functions of the library `lib` whose names hold each of `kernels`
    (cuobjdump -sass)."""
    import re
    import shutil
    from collections import Counter
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    # "/*0a40*/  @!P0 HGMMA.64x128x16.F32.BF16 ..." -> HGMMA.64x128x16...
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Za-z0-9_.]*)")
    hist, cur = {k: Counter() for k in kernels}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = next((k for k in kernels if k in line), None)
        elif cur is not None and (m := op.search(line)):
            hist[cur][m.group(1)] += 1
    return hist


def sass_counts(lib, kernel, opcodes):
    """How many SASS instructions of each opcode (any modifiers) the
    functions of the library `lib` whose names hold `kernel` have."""
    hist = sass_histograms(lib, [kernel])[kernel]
    return {op: sum(n for full, n in hist.items()
                    if full == op or full.startswith(op + "."))
            for op in opcodes}


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


def roofline(ins, outs, flops=()):
    """(bound_ms, bound_by): the least time an H100 SXM takes for the work,
    the larger of its bytes (each input read once, each output written
    once) at 3.35 TB/s and its operations, `flops` ((count, peak FLOP/s),
    ...), whose units run side by side."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs)
                 if torch.is_tensor(t))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max((n / p for n, p in flops), default=0.0) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def peak(t):
    return PEAK_FLOPS[str(t.dtype).replace("torch.", "")]


def compare(name, kernel_fn, plain_fn, make_inputs, timed=True,
            dtypes=("float32", "bfloat16"), bound_fn=None, library_fn=None,
            plain_chunks=None, tf32_bound_fn=None, max_abs=True):
    """kernel vs plain in float32 (tight) and bfloat16 (relative to the
    float32 plain result on the same rounded inputs), in the dtypes the
    kernel takes. ms / plain_ms / library_ms / bound_ms are bfloat16 where
    the kernel takes bfloat16, float32 otherwise (ms_f32, bound_ms_f32 and
    so on beside them). bound_fn(inputs, out) gives (bound_ms, bound_by);
    tf32_bound_fn(inputs, out), for a kernel that runs its float32 products
    as 3xTF32 on the tensor cores, the float32 bound at that rate, which
    then is bound_ms_f32 (the FP32-rate bound is bound_ms_f32_fp32 beside
    it);
    library_fn(*inputs) the one PyTorch call that computes the same
    function, as a callable to time (built outside the timing);
    plain_chunks(inputs) the plain version's inputs in pieces whose outputs
    concatenate along dim 0, where its whole intermediates would not fit;
    max_abs: hold float32 to F32_MAX_ABS too, not only to F32_TOL."""
    import torch
    from e2fgvi_tpu_torch.utils.timing import cuda_ms

    def plain_out(args):
        if plain_chunks is None:
            return plain_fn(*args)
        return torch.cat([plain_fn(*a) for a in plain_chunks(args)])

    res = {}
    if "float32" in dtypes:
        inputs = make_inputs(torch.float32)
        got = kernel_fn(*inputs)
        want = plain_out(inputs)
        rtol, atol = F32_TOL[name]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        res["max_abs_err"] = float((got - want).abs().max())
        bar = F32_MAX_ABS.get(name, float("inf")) if max_abs else float("inf")
        if not res["max_abs_err"] <= bar:
            raise AssertionError(f"{name} f32: max |delta| "
                                 f"{res['max_abs_err']} > "
                                 f"{F32_MAX_ABS[name]}")
        del got, want
    if "bfloat16" in dtypes:
        inputs16 = make_inputs(torch.bfloat16)
        got16 = kernel_fn(*inputs16).float()
        want16 = plain_out([t.float() if torch.is_tensor(t)
                            and t.dtype == torch.bfloat16 else t
                            for t in inputs16])
        rel = float((got16 - want16).abs().max() / want16.abs().max())
        if not rel < BF16_REL[name]:
            raise AssertionError(f"{name} bf16: rel err {rel} >= "
                                 f"{BF16_REL[name]}")
        res["bf16_rel_err"] = rel
        res.setdefault("max_abs_err", float((got16 - want16).abs().max()))
        del got16, want16
    if timed:
        runs = [("", inputs16 if "bfloat16" in dtypes else inputs)]
        if len(dtypes) == 2:
            runs.append(("_f32", inputs))
        for sfx, args in runs:
            res["ms" + sfx] = cuda_ms(lambda: kernel_fn(*args))
            if plain_chunks is None:
                res["plain_ms" + sfx] = cuda_ms(lambda: plain_fn(*args))
            if bound_fn is not None:
                out = kernel_fn(*args)
                res["bound_ms" + sfx], res["bound_by" + sfx] = bound_fn(
                    args, out)
                if tf32_bound_fn is not None and out.dtype == torch.float32:
                    res["bound_ms_f32_fp32"] = res["bound_ms" + sfx]
                    res["bound_ms" + sfx], res["bound_by" + sfx] = \
                        tf32_bound_fn(args, out)
                del out
            if library_fn is not None:
                res["library_ms" + sfx] = cuda_ms(library_fn(*args))
    return res


def _randn_fn(dev, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std
    return randn


def check_kernels(dev, b=B, h=H, w=W, t=17, timed=True):
    """K1, K2 and K3 against their plain versions at serving shapes, K1 in
    float32 also against one TF32 pass; K3 also on one window batch whose
    padding frames leave only the first frame valid."""
    res = check_k1k2(dev, b, h, w, timed, one_pass=True)
    res["focal_attention"], _ = check_k3(dev, b, h, w, t, timed)
    first, _ = check_k3(dev, 1, h, w, t, timed=False, pad="first")
    res["focal_attention"]["first_frame_only"] = first
    return res


def k1k2_inputs(randn, b, h, w):
    """K1's and K2's float32 inputs on b quarter-res maps of h x w: the
    flows, K1's (x, head, weight, bias) and K2's 2b-map feature pair.
    Random heads (std 1): offsets differ per group and tap; some flows push
    samples far outside the image."""
    flow1, flow2 = randn(b, h, w, 2, std=3.0), randn(b, h, w, 2, std=3.0)
    flow1[:, :4, :, 1] -= 40.0
    flow2[:, :, -6:, 0] += 70.0
    k1_base = (randn(b, h, w, 256), randn(b, h, w, 432),
               randn(128, 256, 3, 3, std=0.02), randn(128, std=0.1))
    return flow1, flow2, k1_base, randn(2 * b, h, w, 128)


def k2_library(x, flow):
    """F.grid_sample on K2's channels-last map, the flow turned into its
    normalized grid beforehand: a callable to time."""
    import torch
    _, h, w, _ = x.shape
    gy = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
    gx = torch.arange(w, device=x.device, dtype=torch.float32)
    grid = torch.stack([2 * (gx + flow[..., 0]) / (w - 1) - 1,
                        2 * (gy + flow[..., 1]) / (h - 1) - 1], -1)
    xn = x.permute(0, 3, 1, 2)
    return lambda: torch.nn.functional.grid_sample(
        xn, grid.to(x.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=True)


def check_k1k2(dev, b, h, w, timed=True, dtypes=("float32", "bfloat16"),
               one_pass=False, k1_max_abs=True):
    """K1 and K2 against their plain versions on b quarter-res maps of
    h x w (K2's flow composition in float32 only); one_pass: also what K1
    in float32 with one TF32 pass would miss its plain version by
    (max_abs_err_1xtf32), beside the kernel's max_abs_err; k1_max_abs:
    hold K1 in float32 to F32_MAX_ABS too."""
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    randn = _randn_fn(dev)
    flow1, flow2, k1_base, xfeat = k1k2_inputs(randn, b, h, w)

    def k1_inputs(dt):
        x, head, wt, bias = (v.to(dt) for v in k1_base)
        return x, head, flow1, flow2, wt, bias

    def k1_bound(args, out, tf32=False):
        # the im2col GEMM on the tensor cores (float32: without them, or as
        # three TF32 products) beside the sampler's ~9 float32 operations
        # per im2col element
        x, wt = args[0], args[4]
        cols = (out.numel() // out.shape[-1]) * wt[0].numel()
        return roofline(args, [out], [gemm_ops(2 * cols * out.shape[-1], x,
                                               tf32),
                                      (9 * cols, PEAK_FLOPS["float32"])])

    res = {}
    # no single PyTorch call computes a modulated deformable convolution
    res["deform_conv"] = compare(
        "deform_conv", deform.modulated_deform_conv2d_head,
        deform.deform_conv_head_plain, k1_inputs, timed, dtypes,
        bound_fn=k1_bound, tf32_bound_fn=lambda a, out: k1_bound(a, out, True),
        max_abs=k1_max_abs)
    if one_pass and "float32" in dtypes:
        args = k1_inputs(torch.float32)
        res["deform_conv"]["max_abs_err_1xtf32"] = float(
            (k1_one_tf32_pass(*args) - deform.deform_conv_head_plain(*args))
            .abs().max())
        del args
    if timed:
        res["deform_conv"].update(k1_gemm_and_peak(k1_inputs, dtypes,
                                                   b * h * w))

    # K2 at its two serving shapes: the pair of 128-channel feature warps
    # (2B maps) and the 2-channel flow composition (B maps, float32 only)
    wflow = torch.cat([flow1, flow2], 0)
    res["flow_warp"] = compare(
        "flow_warp", deform.flow_warp, deform.flow_warp_plain,
        lambda dt: (xfeat.to(dt), wflow), timed, dtypes,
        bound_fn=lambda a, out: roofline(
            a, [out], [(8 * out.numel(), PEAK_FLOPS["float32"])]),
        library_fn=k2_library)
    # the 2-channel flow composition on a smooth flow, as SPyNet's are
    fimg = torch.nn.functional.interpolate(
        randn(b, 2, h // 6, w // 6, std=3.0), size=(h, w), mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1).contiguous()
    torch.testing.assert_close(deform.flow_warp(fimg, flow2),
                               deform.flow_warp_plain(fimg, flow2),
                               rtol=1e-5, atol=1e-4)
    return res


def k1_one_tf32_pass(x, head, f1, f2, wt, bias):
    """K1 in float32 with its contraction in one TF32 pass: the plain
    version's samples and the weight rounded to tf32 (the big parts of
    deform.split_tf32), their products summed in float32."""
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    a = deform.split_tf32(deform.deform_columns_plain(x, head, f1, f2))[0]
    (w_big, _), b32 = deform.conv_operands(wt, bias, torch.float32)
    out = torch.addmm(b32, a, w_big.T)
    return out.reshape(*head.shape[:3], w_big.shape[0])


def gemm_ops(flops, x, tf32=False):
    """(operations, peak FLOP/s) of a matrix product on x's dtype; tf32:
    float32 as three TF32 products (3xTF32) on the tensor cores."""
    return (3 * flops, PEAK_FLOPS["tf32"]) if tf32 else (flops, peak(x))


def k1_gemm_and_peak(k1_inputs, dtypes, m):
    """gemm_ms: cuBLAS col @ w_r on a random M x 2304 im2col matrix, the
    contraction alone (what the float32 K1 ran after an im2col kernel
    before it fused both; a yardstick the port never calls); peak_mib: the
    peak device memory of one K1 call above what was allocated before it.
    Suffixed _f32 as compare() suffixes."""
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    res = {}
    for dt in dtypes:
        sfx = "_f32" if dt == "float32" and "bfloat16" in dtypes else ""
        x, head, f1, f2, wt, bias = k1_inputs(getattr(torch, dt))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            deform.modulated_deform_conv2d_head(x, head, f1, f2, wt, bias)
        torch.cuda.synchronize()
        res["peak_mib" + sfx] = (torch.cuda.max_memory_allocated()
                                 - before) / 2**20
        kdim = wt[0].numel()
        col = torch.randn((m, kdim), device=x.device).to(x.dtype)
        w_r = torch.randn((kdim, wt.shape[0]), device=x.device).to(x.dtype)
        res["gemm_ms" + sfx] = cuda_ms(lambda: col @ w_r)
        del col
    return res


def k3_inputs(dev, b, h, w, t=17, pad="serving"):
    """K3's inputs for b windows of T=t frames on the token grid of an
    h x w quarter-res map, with the real deduplicated key table and padding
    frames: pad "serving" pads frames 6-10, 9-10 and 15-16 of the first
    three windows, "first" every frame but the first. Each window's key
    panel is its own keys, then its gathered keys frame by frame (the order
    models/tfocal.py builds). Returns (make_inputs(dtype), nwin, S)."""
    import torch
    from e2fgvi_tpu_torch.models import tfocal
    randn = _randn_fn(dev)
    heads, hd, wh, ww = 4, 128, 5, 9
    fh, fw = tfocal.token_grid((h, w))
    _, bias_rows, s = tfocal._window_tables(
        fh, fw, wh, ww, 2, 4, -(-fh // wh), -(-fw // ww), t,
        torch.device(dev))
    nwin = (fh // wh) * (fw // ww)
    nq = t * wh * ww
    fv = torch.ones((b, t), dtype=torch.bool, device=dev)
    if pad == "first":
        fv[:, 1:] = False
    else:
        for i, frames in enumerate((slice(6, 11), slice(9, 11),
                                    slice(15, None))):
            if i < b:
                fv[i, frames] = False
    bias_g = bias_rows[None, :, None, :].expand(b, nwin, t, s)
    bias_g = torch.where(fv[:, None, :, None], bias_g,
                         torch.full_like(bias_g, -1e9))
    bias_o = torch.where(fv, 0.0, -1e9)[:, None, :, None].expand(
        b, nwin, t, wh * ww)
    bias = torch.cat([bias_o.reshape(b, nwin, nq),
                      bias_g.reshape(b, nwin, t * s)], -1)
    bias = bias.reshape(b * nwin, nq + t * s).contiguous()
    # the draws of the two-panel layout (q, own k, own v, gathered k,
    # gathered v) joined into one panel: the same inputs as before it
    q = randn(b * heads * nwin, nq, hd, std=hd ** -0.5)
    kv = []
    for _ in range(2):
        kv.append(randn(b * heads * nwin, nq, hd))
    for i in range(2):
        g = randn(b * heads, t, nwin, s, hd).reshape(b, heads, t, nwin, s, hd)
        g = g.permute(0, 1, 3, 2, 4, 5).reshape(b, heads, nwin, t * s, hd)
        own = kv[i].reshape(b, heads, nwin, nq, hd)
        kv[i] = torch.cat([own, g], 3).reshape(b * heads * nwin, -1, hd)
        del g, own

    def make_inputs(dt):
        return (q.to(dt), kv[0].to(dt), kv[1].to(dt), bias, b, heads)
    return make_inputs, nwin, s


def k3_bound(args, out, tf32=False):
    q, k, _, _, _, _ = args
    return roofline(args[:4], [out],
                    [gemm_ops(4 * q.numel() * k.shape[1], q, tf32)])


def k3_library(q, k, v, bias, b, heads):
    """scaled_dot_product_attention over each (b, head, window)'s panel with
    the bias as its additive mask (in q's dtype, as SDPA takes it)."""
    import torch
    import torch.nn.functional as F
    p, nk = q.shape[0], k.shape[1]
    nwin = bias.shape[0] // b
    mask = bias.reshape(b, 1, nwin, 1, nk).expand(b, heads, nwin, 1, nk)
    mask = mask.reshape(p, 1, 1, nk).to(q.dtype)
    q4, k4, v4 = (z.view(p, 1, z.shape[1], z.shape[2]) for z in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=mask, scale=1.0)


def k3_chunks(args):
    """The plain version's inputs one batch element at a time."""
    q, k, v, bias, b, heads = args
    n, nw = q.shape[0] // b, bias.shape[0] // b
    return [(q[i * n:(i + 1) * n], k[i * n:(i + 1) * n],
             v[i * n:(i + 1) * n], bias[i * nw:(i + 1) * nw], 1, heads)
            for i in range(b)]


def check_k3(dev, b, h, w, t=17, timed=True, pad="serving", chunked=False):
    """K3 against its plain version (see k3_inputs), with its bound and
    SDPA's time; chunked runs the plain version one batch element at a
    time. Returns compare()'s result and the geometry (nwin, S)."""
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    make_inputs, nwin, s = k3_inputs(dev, b, h, w, t, pad)
    return compare("focal_attention", fa.focal_attention,
                   fa.focal_attention_plain, make_inputs, timed,
                   bound_fn=k3_bound, library_fn=k3_library,
                   tf32_bound_fn=lambda a, out: k3_bound(a, out, True),
                   plain_chunks=k3_chunks if chunked else None), (nwin, s)


SERVING_KERNELS = ("deform", "focal_attention")
SERVING_NAMES = ("deform_conv", "flow_warp", "focal_attention")
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
        ff_all, fb_all = e2fgvi.spynet_pairs(model32.update_spynet,
                                             small[:-1], small[1:])
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
    token grid (64 windows, S=149) at B=2, at B against the plain
    version run one batch element at a time (its float32 logits at B are
    ~36 GB), and at B=1 with only the first frame valid. 1296x720 (1280x720
    mirror-padded): K3 on the 60x108 grid (144 windows, S=153) at B=1;
    K1 at B on 180x324 maps, whose im2col matrix (1.88e9 elements, 7.5 GB
    in float32) only the plain version makes, and K2 there."""
    import torch
    res = {}
    for label, (h, w), b3, geom in (("864x480", HQ_MAP, 2, (64, 149)),
                                    ("1296x720", HQ720_MAP, 1, (144, 153))):
        # at 324 columns the f32 K1 reads ~2e-5 from its plain version and
        # ~3e-5 from K1 in float64: held to F32_TOL only there
        res[label] = check_k1k2(dev, B, h, w,
                                k1_max_abs=label != "1296x720")
        torch.cuda.empty_cache()
        k3, (nwin, s) = check_k3(dev, b3, h, w)
        if (nwin, s) != geom:
            raise AssertionError(f"{label}: {nwin} windows, S={s}; "
                                 f"expected {geom}")
        res[label]["focal_attention"] = {"batch": b3, "nwin": nwin, "S": s,
                                         **k3}
        torch.cuda.empty_cache()
    k3, _ = check_k3(dev, B, *HQ_MAP, chunked=True)
    res["864x480"]["focal_attention"][f"b{B}"] = k3
    first, _ = check_k3(dev, 1, *HQ_MAP, timed=False, pad="first")
    res["864x480"]["focal_attention"]["first_frame_only"] = first
    torch.cuda.empty_cache()
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


def write_vos(root, n_videos, t, h, w, seed=0):
    """A YouTube-VOS-layout training set under root/youtube-vos
    (JPEGImages/<v>.zip of t JPEG frames, train.json): smooth noise."""
    import zipfile
    from PIL import Image
    vos = os.path.join(root, "youtube-vos")
    os.makedirs(os.path.join(vos, "JPEGImages"))
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        low = rng.integers(0, 255, (t, h // 8, w // 8, 3), dtype=np.uint8)
        with zipfile.ZipFile(os.path.join(vos, "JPEGImages", f"v{v}.zip"),
                             "w") as zf:
            for i in range(t):
                jpg = os.path.join(root, "frame.jpg")
                Image.fromarray(low[i]).resize((w, h), Image.BILINEAR).save(
                    jpg, quality=90)
                zf.write(jpg, arcname=f"{i:05d}.jpg")
    with open(os.path.join(vos, "train.json"), "w") as f:
        json.dump({f"v{v}": t for v in range(n_videos)}, f)
    return root


def train_config(name, root, save_dir, **trainer):
    """configs/<name> as it is, pointed at the synthetic set and save_dir,
    with `trainer` keys overridden."""
    with open(os.path.join(ROOT, "configs", name)) as f:
        cfg = json.load(f)
    cfg["save_dir"] = save_dir
    cfg["train_data_loader"]["data_root"] = root
    cfg["trainer"].update(trainer)
    return cfg


def set_deterministic(on):
    import torch
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def snapshot(*modules):
    return [{k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
            for m in modules]


def to_host(x):
    import torch
    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def train_state_dict(state):
    """What a restore must bring back, on the host: the generator, the
    discriminator (with its spectral-norm vectors), the frozen SPyNet, both
    optimizers and the iteration."""
    return to_host({"gen": state.gen.state_dict(),
                    "dis": state.dis.state_dict(),
                    "fixed_spynet": state.fixed_spynet.state_dict(),
                    "opt_g": state.opt_g.state_dict(),
                    "opt_d": state.opt_d.state_dict(), "step": state.step})


def unequal(a, b, path=""):
    """The paths at which a and b differ; tensors bit for bit."""
    import torch
    if torch.is_tensor(a) or torch.is_tensor(b):
        same = (torch.is_tensor(a) and torch.is_tensor(b)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} (keys)"]
        return [p for k in a for p in unequal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} (length)"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in unequal(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def count_tensors(x):
    import torch
    if isinstance(x, dict):
        return sum(count_tensors(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(count_tensors(v) for v in x)
    return int(torch.is_tensor(x))


def finite_logs(logs, label):
    bad = {k: v for k, v in logs.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"{label}: losses not finite: {bad}")


def one_batch(dataset, n):
    """The first n items of epoch 1 of a TrainDataset."""
    import torch
    items = [dataset.__getitem__(i, epoch=1) for i in range(n)]
    return (torch.from_numpy(np.stack([it[0] for it in items])),
            torch.from_numpy(np.stack([it[1] for it in items])))


def train_base(dev, root, save_dir, batch):
    """The base config's Trainer for TRAIN_STEPS steps at `batch`, saving
    at step 2: per-step seconds (CUDA events between the steps' ends),
    peak memory, losses, K1-K3 launches (forward and remat apart: one
    forward with grad and remat counted alone), parameters moved and the
    frozen SPyNet not; then a fresh Trainer restored at step 2 must hold
    the uninterrupted run's state at step 2 bit for bit (train_state_dict,
    copied to the host outside the timed steps) and runs step 3 again,
    cuDNN deterministic for both runs of step 3."""
    import torch
    from e2fgvi_tpu_torch.train.trainer import Trainer
    cfg = train_config("train_e2fgvi.json", root, save_dir,
                       batch_size=batch, save_freq=2, log_freq=1)
    tr = Trainer(cfg, device=dev)
    (g0, f0) = snapshot(tr.state.gen, tr.state.fixed_spynet)
    starts, ends = [torch.cuda.Event(enable_timing=True)], []
    logs, step2, step3 = {}, {}, {}

    def on_step(it, lg):
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        logs[it] = {k: float(v) for k, v in lg.items()}
        if it == 2:
            step2["state"] = train_state_dict(tr.state)
            set_deterministic(True)
        if it == 3:
            step3["params"] = snapshot(tr.state.gen, tr.state.dis)
            set_deterministic(False)
        starts.append(torch.cuda.Event(enable_timing=True))
        starts[-1].record()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    starts[0].record()
    tr.train(max_steps=TRAIN_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    counts = launch_counts()
    res = {"batch": batch, "step_s": [a.elapsed_time(b) / 1e3 for a, b in
                                      zip(starts, ends)],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": logs, "launches": counts}
    for it, lg in logs.items():
        finite_logs(lg, f"train step {it}")
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"training missed a kernel: {counts}")
    (g1, f1) = snapshot(tr.state.gen, tr.state.fixed_spynet)
    res["moved"] = sum(not torch.equal(g0[k], g1[k]) for k in g0)
    if res["moved"] < len(g0) // 2:
        raise AssertionError(f"{res['moved']} of {len(g0)} generator "
                             "tensors moved")
    if not all(torch.equal(f0[k], f1[k]) for k in f0):
        raise AssertionError("the frozen SPyNet moved")

    frames, masks = one_batch(tr.dataset, batch)
    frames, masks = frames.to(dev), masks.to(dev)
    reset_launch_counts()
    pred, flows = tr.state.gen(frames * (1 - masks), tr.lt, remat=True)
    fwd = launch_counts()
    del pred, flows, frames, masks
    res["launches_forward_per_step"] = fwd
    res["launches_remat_per_step"] = {
        k: counts[k] / TRAIN_STEPS - fwd[k] for k in counts}
    if res["launches_remat_per_step"] != {k: float(v) for k, v in
                                          fwd.items()}:
        raise AssertionError(f"remat did not run every kernel again: "
                             f"{res['launches_remat_per_step']} vs {fwd}")

    # resume from step 2 and run step 3 again
    set_deterministic(True)
    again = Trainer(cfg, device=dev)
    if again.ckpt.restore(again.state, it=2) != 2 or again.iteration != 2:
        raise AssertionError("no checkpoint at step 2")
    off = unequal(train_state_dict(again.state), step2["state"])
    if off:
        raise AssertionError(f"the restore at step 2 differs from the "
                             f"uninterrupted run's state at: {off[:20]}")
    restored = count_tensors(step2.pop("state"))
    resumed = {}
    again.train(max_steps=1, on_step=lambda it, lg: resumed.update(
        {k: float(v) for k, v in lg.items()}))
    set_deterministic(False)
    res["resume"] = resume_delta(resumed, logs[3], snapshot(
        again.state.gen, again.state.dis), step3["params"],
        float(cfg["trainer"]["lr"]))
    res["resume"]["restored_tensors_bit_equal"] = restored
    tr.close()
    again.close()
    return res


def resume_delta(logs, want_logs, params, want_params, lr):
    """The resumed step 3 against the uninterrupted one. Its forward is
    deterministic, so the losses must be equal; the backward sums some
    gradients with atomics (the plain K1/K2 backward's scatter-adds, the
    attention panels' index_add), so a parameter may differ by at most two
    Adam steps at step 3 (|update| <= lr sqrt((1 - 0.99^3) / 0.01) =
    1.73 lr with beta1 = 0)."""
    import torch
    rel = max(abs(logs[k] - want_logs[k]) / max(abs(want_logs[k]), 1e-12)
              for k in want_logs)
    if set(logs) != set(want_logs) or not rel <= 1e-6:
        raise AssertionError(f"resumed step 3 losses {logs} != {want_logs}")
    diff, equal, total = 0.0, 0, 0
    for got, want in zip(params, want_params):
        for k, v in want.items():
            if v.is_floating_point():
                d = float((got[k] - v).abs().max()) if v.numel() else 0.0
                diff = max(diff, d)
                equal += int(torch.equal(got[k], v))
                total += 1
    if not diff <= 3.5 * lr:
        raise AssertionError(f"resumed step 3 params off by {diff}")
    return {"losses_max_rel": rel, "params_max_abs": diff,
            "tensors_bit_equal": f"{equal}/{total}"}


def train_card_vs_cpu(dev, root):
    """One step at b=1 from one seeded state on the card (the kernels) and
    on the CPU (the plain versions): losses within 1e-4 relative; every
    gradient g within ||g - g_cpu|| <= 1e-2 ||g_cpu|| + 1e-6 sqrt(numel)
    (3xTF32 K1, cuDNN and atomics against float32 on the CPU; the floor
    for gradients that cancel to ~1e-6)."""
    from e2fgvi_tpu_torch.data.datasets import TrainDataset
    from e2fgvi_tpu_torch.train import schedules
    from e2fgvi_tpu_torch.train import step as step_lib
    from e2fgvi_tpu_torch.train.trainer import build_models
    cfg = train_config("train_e2fgvi.json", root, None)
    data = cfg["train_data_loader"]
    frames, masks = one_batch(TrainDataset(data, seed=cfg["seed"]), 1)
    lr_fn = schedules.make_schedule(cfg["trainer"]["scheduler"],
                                    cfg["trainer"]["lr"])
    step = step_lib.make_train_step(data["num_local_frames"], cfg["losses"])
    out = {}
    for d in ("cpu", dev):
        gen, dis = build_models(cfg, d)
        st = step_lib.TrainState(gen, dis, lr_fn)
        t0 = time.perf_counter()
        logs = step(st, frames.to(d), masks.to(d))
        out[d] = ({k: float(v) for k, v in logs.items()},
                  {f"{m}.{k}": p.grad.detach().cpu().double()
                   for m, mod in (("gen", gen), ("dis", dis))
                   for k, p in mod.named_parameters()},
                  time.perf_counter() - t0)
        del gen, dis, st
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out[dev]
    finite_logs(lg, "card step")
    loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    worst, over = 0.0, {}
    for k, want in gc.items():
        err = float((gg[k] - want).norm())
        bound = 1e-2 * float(want.norm()) + 1e-6 * want.numel() ** 0.5
        worst = max(worst, err / bound)
        if not err <= bound:
            over[k] = (err, bound)
    if not loss_rel <= 1e-4 or over:
        raise AssertionError(f"card vs CPU step: losses rel {loss_rel}, "
                             f"gradients over their bound {over}")
    return {"losses_max_rel": loss_rel, "grad_err_over_bound_max": worst,
            "cpu_s": sc, "card_s": sg}


def train_hq(dev, root, batch=2):
    """One step of configs/train_e2fgvi_hq.json at `batch`."""
    import torch
    from e2fgvi_tpu_torch.train.trainer import Trainer
    cfg = train_config("train_e2fgvi_hq.json", root,
                       os.path.join(root, "hq"), batch_size=batch)
    tr = Trainer(cfg, device=dev)
    logs = {}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.train(max_steps=1, on_step=lambda it, lg: logs.update(
        {k: float(v) for k, v in lg.items()}))
    torch.cuda.synchronize()
    res = {"batch": batch, "s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "losses": logs, "launches": launch_counts()}
    tr.close()
    finite_logs(logs, "hq step")
    if tr.iteration != 1 or not all(v > 0 for v in res["launches"].values()):
        raise AssertionError(f"hq step: {res}")
    return res


def run_train(dev, tmp):
    """Phase 9: the base config's Trainer at its batch 8 (batch 4 where 8
    runs out of memory, said so), the resume check, one step card against
    CPU at b=1, one HQ step at batch 2."""
    import torch
    root = write_vos(tmp, TRAIN_VIDEOS, 20, 240, 432)
    res = {}
    try:
        res["base"] = train_base(dev, root, os.path.join(tmp, "b8"), 8)
    except torch.cuda.OutOfMemoryError as e:
        log(f"train: out of memory at batch 8: {e}")
        res["oom_batch8"] = str(e)
        torch.cuda.empty_cache()
        res["base"] = train_base(dev, root, os.path.join(tmp, "b4"), 4)
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = train_card_vs_cpu(dev, root)
    torch.cuda.empty_cache()
    res["hq"] = train_hq(dev, root)
    torch.cuda.empty_cache()
    return res


def e3_library(tab, idx):
    """torch.gather on E3's table, the index widened to int64 beforehand: a
    callable to time."""
    import torch
    flat = idx.reshape(-1, idx.shape[-1]).long()
    return lambda: torch.gather(tab, 0, flat)


def e4_library(tab, py, px, h, w):
    """F.grid_sample on E4's table, the G lane groups as G images (lane j
    is group j % G) and the positions as a normalized grid (align_corners),
    made beforehand: a callable to time."""
    import torch
    g = py.shape[-1]
    img = tab.reshape(h, w, -1, g).permute(3, 2, 0, 1)
    grid = torch.stack([2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1], -1)
    grid = grid.permute(2, 0, 1, 3).contiguous()
    return lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


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

    def sampler_bound(args, out):
        # the bilinear sum (8) and the mask (1) per output element
        return roofline(args[:4], [out],
                        [(9 * out.numel(), PEAK_FLOPS["float32"])])

    # no single PyTorch call computes the banded sampler (K1's inner loop)
    res, exact = {}, {}
    src, *pos, dy_lo = ei.make_inputs(dev)          # E5/E6: band 24
    res["band_sample"] = compare(
        "band_sample", bs.band_sample, bs.band_sample_plain,
        lambda dt: (src.to(dt), *pos, dy_lo), bound_fn=sampler_bound)
    res["band_sample_cbatch"] = compare(
        "band_sample_cbatch", bs.band_sample_cbatch,
        bs.band_sample_cbatch_plain, lambda dt: (src.to(dt), *pos, dy_lo),
        bound_fn=sampler_bound)
    psrc = bs.pack_xpairs(src)
    res["band_sample_xpair"] = compare(
        "band_sample_xpair", bs.band_sample_xpair,
        lambda p, *a: bs.band_sample_plain(bs.unpack_xpairs(p).float(), *a),
        lambda dt: (psrc, *pos, dy_lo), dtypes=("bfloat16",),
        bound_fn=sampler_bound)
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
        lambda dt: (pc, *pos, dy_lo), dtypes=("bfloat16",),
        bound_fn=sampler_bound)
    exact["E1 cpair"] = torch.equal(bs.band_sample_cpair(pc, *pos, dy_lo),
                                    bs.band_sample(src, *pos, dy_lo))
    del src, pos, pc
    torch.cuda.empty_cache()
    if not all(exact.values()):
        raise AssertionError(f"packed samplers not bit-equal to E5: {exact}")

    tab, idx, gpy, gpx = eg.make_inputs(dev)        # E3/E4: 60x108, 9 taps
    res["row_gather"] = compare("row_gather", gather.row_gather,
                                gather.row_gather_plain,
                                lambda dt: (tab.to(dt), idx),
                                bound_fn=lambda a, out: roofline(a, [out]),
                                library_fn=e3_library)
    res["bilinear4_sample"] = compare(
        "bilinear4_sample", gather.bilinear4_sample,
        gather.bilinear4_sample_plain, lambda dt: (tab, gpy, gpx, H, W),
        dtypes=("float32",),
        bound_fn=lambda a, out: roofline(
            a[:3], [out], [(8 * out.numel(), PEAK_FLOPS["float32"])]),
        library_fn=e4_library)

    block, x, pooled = ea.make_block(dev)           # E2: B 14, T 17

    def band_attention_bound(args, out):
        # the qkv GEMMs (tokens and pooled tokens), attention over each
        # window's T * 210 in-place keys, and the proj GEMM, at bf16 rates
        attn, x, pooled, heads, (wh, ww), _ = args
        b, t, h, w, c = x.shape
        tokens, nwin = b * t * h * w, (h // wh) * (w // ww)
        nk = t * ba.slot_offsets(wh, ww, *args[5])[0].shape[0]
        flops = (2 * (tokens + pooled[..., 0].numel()) * c * 3 * c
                 + 4 * b * nwin * t * wh * ww * nk * c
                 + 2 * tokens * c * c)
        weights = (attn.qkv.weight, attn.qkv.bias, attn.proj.weight,
                   attn.proj.bias)
        return roofline([x, pooled, *weights], [out], [(flops, peak(x))])

    res["band_attention"] = compare(
        "band_attention", ba.band_attention, ba.band_attention_plain,
        lambda dt: (block.attn, x, pooled, ea.HEADS, ea.WIN, ea.EXP),
        dtypes=("bfloat16",), bound_fn=band_attention_bound)
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
    lib_path, nvcc_log = build.build()
    build.library()
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  " + line.strip())
    # the bf16 K3 must run on wgmma fed by TMA
    ops = sass_counts(lib_path, "focal_attention_wgmma_kernel",
                      ("HGMMA", "UTMALDG", "HMMA"))
    log(f"bf16 K3 SASS opcodes: {json.dumps(ops)}")
    if not (ops["HGMMA"] and ops["UTMALDG"]):
        raise AssertionError(f"bf16 K3 is not on wgmma + TMA: {ops}")
    # K1: sampler and wgmma contraction in one kernel, the weight by TMA;
    # in float32 on TF32 wgmma (3xTF32)
    ops = sass_counts(lib_path, "deform_conv_wgmma_kernel",
                      ("HGMMA", "UTMALDG", "HMMA"))
    log(f"bf16 K1 SASS opcodes: {json.dumps(ops)}")
    if not (ops["HGMMA"] and ops["UTMALDG"]):
        raise AssertionError(f"bf16 K1 is not on wgmma + TMA: {ops}")
    hist = sass_histograms(lib_path, ["deform_conv_tf32_kernel"])[
        "deform_conv_tf32_kernel"]
    ops = {op: n for op, n in hist.items()
           if op.startswith(("HGMMA", "UTMALDG", "HMMA"))}
    log(f"f32 K1 SASS opcodes: {json.dumps(ops)}")
    if not (any(op.startswith("HGMMA") and "TF32" in op for op in ops)
            and any(op.startswith("UTMALDG") for op in ops)):
        raise AssertionError(f"f32 K1 is not on TF32 wgmma + TMA: {ops}")
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

    # 9. train: the Trainer on the base config, resume, card vs CPU, HQ
    with tempfile.TemporaryDirectory() as tmp:
        tres = run_train(dev, tmp)
    for name, r in tres.items():
        log(f"train {name}: " + json.dumps(r))
    base = tres["base"]
    log(f"train base batch {base['batch']}: s/step "
        + ", ".join(f"{x:.3f}" for x in base["step_s"])
        + f"; peak {base['peak_gib']:.2f} GiB; launches forward/step "
        f"{json.dumps(base['launches_forward_per_step'])}, remat/step "
        f"{json.dumps(base['launches_remat_per_step'])}")
    t0 = phase_end("train", t0)
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
    k1_keys = ("gemm_ms", "gemm_ms_f32", "peak_mib", "peak_mib_f32",
               "max_abs_err_1xtf32")
    extra = ("ms_f32", "plain_ms_f32", "bound_ms_f32", "bound_ms_f32_fp32",
             "library_ms_f32", "bf16_rel_err", *k1_keys)
    hq_keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ms_f32",
               "plain_ms_f32", "bound_ms_f32", "bound_ms_f32_fp32",
               "library_ms_f32",
               "max_abs_err", "bf16_rel_err", f"b{B}", *k1_keys)
    for name, (src, replaces) in REPLACES.items():
        r = kres[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": counts[name],
                 "launches_train": base["launches"].get(name, 0),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"],
                 "library_ms": r.get("library_ms"),
                 **{k: r[k] for k in extra if k in r}}
        if name in SERVING_NAMES:     # the HQ shapes' numbers (phase 7)
            entry["hq"] = {label: {k: v for k, v in hres[label][name].items()
                                   if k in hq_keys}
                           for label in hres}
        kernels.append(entry)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
