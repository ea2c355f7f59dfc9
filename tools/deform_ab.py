#!/usr/bin/env python3
"""The kernels of one tree of the port, timed apart, for A/B runs on one
card.

    python3 tools/deform_ab.py --root <tree> --tag <name> [--out <dir>]
                               [--parts deform gather accuracy serve_f32
                                        serve_bf16 band_attention
                                        band_sampler]
    python3 tools/deform_ab.py --compare <dir>/<a>.pt <dir>/<b>.pt
    python3 tools/deform_ab.py --summarize <tree>_<pair>.jsonl ...

The first form imports e2fgvi_tpu_torch from <tree> (a checkout of any
commit of the port; its kernels build into <tree>/build) and times it with
that tree's utils.timing.cuda_ms (one call between CUDA events after a
sync, the wrapper's host time included). `--parts` picks what it runs:

- `deform` (default), on chip_smoke.py's inputs (chip_smoke.k1k2_inputs)
  at base (60x108 maps) and 864x480 (120x216), B=14, in float32 and
  bfloat16: K1 whole (modulated_deform_conv2d_head), with
  chip_smoke.k1_gemm_and_peak: the contraction alone (cuBLAS on a random
  M x 2304 matrix) and the peak device memory of one call; the im2col
  kernel alone in a tree whose bfloat16 K1 still writes an im2col matrix;
  K2 on the pair of 128-channel feature warps (2B
  maps) beside F.grid_sample, and on the 2-channel flow composition
  (float32); K3 at base B=14 in both dtypes, and the float32 K3 at
  864x480 (chip_smoke.k3_inputs on 120x216 maps: 64 windows, S=149) at
  B=2 and B=14, each with its bound at the 3xTF32 rate;
- `gather` (default), on experiments.exp_gather.make_inputs (9 taps of a
  60x108 map, 128 lanes, 16 groups): E3 row_gather in float32 and
  bfloat16 beside torch.gather (the index widened to int64 beforehand,
  chip_smoke.e3_library) and E4 bilinear4_sample beside F.grid_sample
  (chip_smoke.e4_library), each also split into host and device parts
  (`split`), as is K2's base float32 pair; and the host microseconds a
  call of the launch path's pieces (build.stream_args, check_cuda_inputs,
  a one-row E3 call);
- `accuracy`: the float32 K1 on chip_smoke.py's inputs at base, 864x480
  and 1296x720 (B=14): max |delta| of the kernel and of the plain version
  from K1 of the same inputs in float64 throughout (k1_float64: offsets,
  sample positions, samples and the contraction), which holds each to
  the exact function of its float32 inputs. The kernel's distance
  from the plain version and one TF32 pass's are in chip_smoke.py's
  kernels line (max_abs_err, max_abs_err_1xtf32);
- `serve_f32`: chip_smoke.serve in float32 at the inpaint CLI's defaults
  (max_batch 4) with the golden weights: base 432x240, 2 videos of 70
  frames (chip_smoke phase 5), and HQ 864x480, one of 20 (phase 7):
  frames/s, stage ms a video and the peak device memory of the runs;
- `serve_bf16`: the same in bfloat16 at max_batch 14: base, 3 videos of
  70 frames (phase 5), and HQ 864x480, 2 of 70 (phase 7);
- `band_attention`: E2 on experiments.exp_attn_band_r04.make_block's
  inputs (B=14, T=17, 20x36 tokens, C=512, 4 heads): its layer (`ms`:
  the qkv GEMMs, the kernel, proj), the kernel alone on the layer's qkv
  maps (`kernel_ms`; in a tree before band_attention_kernel, its entry
  point called as that tree's wrapper calls it), K3's layer on the same
  inputs (`k3_layer_ms`, tfocal.window_attention) and K3 alone on
  chip_smoke.k3_inputs at base in bfloat16 (`k3_ms`);
- `band_sampler`: the banded samplers (kernels/band_sampler.py) at
  experiments.exp_dcn_inner_r04.make_inputs' shape (band 24): E5
  band_sample in bfloat16, in float32 and on a float32 source with a
  bfloat16 output (the experiment's `base`), band_sample_cbatch in both
  dtypes, E6 band_sample_xpair; and at experiments.exp_dcn_pack's (band
  48): E5 in bfloat16 (its `current`) and E1 band_sample_cpair, the
  control. Each with `ms` (cuda_ms, the wrapper's host time included) and
  `split` (host and device apart; `device_us` by kernel name), its plain
  version's `plain_ms` once a shape, and the kernel's bound (chip_smoke's
  roofline: the inputs once, the output once, 9 float32 operations an
  output).

Every part also prints the SASS opcode histogram of its kernels
(cuobjdump): load and store opcodes in full, the rest as a digest. The
outputs of K1, K2 and the float32 K3 at base and of E3 and E4 go to
<dir>/<tag>.pt. The second form says which saved outputs are bit-equal
between two trees, and whether the float32 K1's and K3's, which need not
be (their 3xTF32 products sum in other orders than float32 does), are
within chip_smoke.F32_MAX_ABS's bar for the kernel against its plain
version. The third
form reads the first form's output, saved as <tree>_<pair>.jsonl a
run, and prints each tree's medians, minima and maxima and, pair by pair, how often each ms
was below its library call's (same run) and below the other tree's (same
pair). Every result line is JSON; the card's name and power limit come
first.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"base": (14, 60, 108), "864x480": (14, 120, 216)}
ACCURACY_SHAPES = {**SHAPES, "1296x720": (14, 180, 324)}
SASS = {"deform": ("deform_conv_tf32_kernel", "flow_warp_kernel",
                   "deform_conv_wgmma_kernel", "focal_attention_wgmma_kernel",
                   "focal_attention_3xtf32_kernel",
                   "focal_attention_tf32_kernel"),
        "gather": ("row_gather_kernel", "bilinear4", "group_major_kernel"),
        "accuracy": ("deform_conv_tf32_kernel",), "serve_f32": (),
        "serve_bf16": (),
        "band_attention": ("band_attention_kernel",
                           "focal_attention_wgmma_kernel"),
        "band_sampler": ("band_staged_kernel", "band_sample_kernel",
                         "band_sample_cbatch_kernel",
                         "band_sample_xpair_kernel",
                         "band_sample_cpair_kernel")}
SPLIT_CALLS = 200
GATHER_ITERS = 50    # cuda_ms calls a median for the ~0.05 ms gathers
# (kernel's ms, its library call's ms) keys of a result line
LIBRARY_KEYS = (("ms", "library_ms"), ("k2_ms", "grid_sample_ms"))
# saved outputs compared within a max |delta| instead of bit for bit, by
# the chip_smoke.F32_MAX_ABS entry of their kernel
TOLERANCE_OF = {"k1_float32": "deform_conv",
                "k3_float32": "focal_attention"}
# the float32 K3's shapes beside base: (B, map h, map w)
K3_F32_SHAPES = {"864x480 b2": (2, 120, 216), "864x480": (14, 120, 216)}


def chip_smoke():
    """This checkout's chip_smoke.py, whatever tree the package comes from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, n=2000):
    """Host microseconds a call of fn, over n calls."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def split(fn, n=SPLIT_CALLS):
    """A call's host and device parts: `host_us`, the host clock around n
    enqueues after a sync; `events_us`, CUDA events around the same n
    back-to-back calls (the larger of host and device a call);
    `device_us`, torch.profiler's device time a call, in all and by kernel
    name (`kernels`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    b.record()
    b.synchronize()
    events = a.elapsed_time(b) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            kernels[e.key[:80]] = t / n
    return {"host_us": host, "events_us": events,
            "device_us": sum(kernels.values()) if kernels else None,
            "kernels": kernels}


def run_deform(cs, tag, dev, saved):
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    for label, (b, h, w) in SHAPES.items():
        flow1, flow2, k1_base, xfeat = cs.k1k2_inputs(cs._randn_fn(dev),
                                                      b, h, w)
        wflow = torch.cat([flow1, flow2], 0)
        for dt in ("float32", "bfloat16"):
            x, head, wt, bias = (v.to(getattr(torch, dt)) for v in k1_base)
            xf = xfeat.to(x.dtype)
            res = {"tag": tag, "shape": label, "dtype": dt}
            with torch.inference_mode():
                k1 = lambda: deform.modulated_deform_conv2d_head(  # noqa: E731
                    x, head, flow1, flow2, wt, bias)
                res["k1_ms"] = cuda_ms(k1)
                res.update(cs.k1_gemm_and_peak(
                    lambda _: (x, head, flow1, flow2, wt, bias), (dt,),
                    b * h * w))
                if dt == "bfloat16" and not hasattr(deform,
                                                    "deform_conv_fused"):
                    # a tree whose bf16 K1 is still im2col + GEMM
                    res["im2col_ms"] = cuda_ms(lambda: deform.deform_im2col(
                        x, head, flow1, flow2))
                res["k2_ms"] = cuda_ms(lambda: deform.flow_warp(xf, wflow))
                res["grid_sample_ms"] = cuda_ms(cs.k2_library(xf, wflow))
                if dt == "float32":
                    res["k2_flow_ms"] = cuda_ms(
                        lambda: deform.flow_warp(flow1, flow2))
                if label == "base":
                    saved[f"k1_{dt}"] = k1().cpu()
                    saved[f"k2_{dt}"] = deform.flow_warp(xf, wflow).cpu()
                    if dt == "float32":
                        saved["k2_flow"] = deform.flow_warp(flow1,
                                                            flow2).cpu()
            print(json.dumps(res), flush=True)
            del x, head, xf
            torch.cuda.empty_cache()
    for label, shape in (("base", SHAPES["base"]), *K3_F32_SHAPES.items()):
        make_inputs, _, _ = cs.k3_inputs(dev, *shape)
        res = {"tag": tag, "shape": label, "kernel": "focal_attention"}
        for dt in ("bfloat16", "float32") if label == "base" else (
                "float32",):
            args = make_inputs(getattr(torch, dt))
            with torch.inference_mode():
                sfx = "" if dt == "bfloat16" else "_f32"
                res["ms" + sfx] = cuda_ms(lambda: fa.focal_attention(*args))
                if dt == "float32":
                    out = fa.focal_attention(*args)
                    res["bound_ms_f32"] = cs.k3_bound(args, out, True)[0]
                    if label == "base":
                        saved["k3_float32"] = out.cpu()
                    del out
            del args
        print(json.dumps(res), flush=True)
        del make_inputs
        torch.cuda.empty_cache()


def run_gather(cs, tag, dev, saved):
    import torch
    from e2fgvi_tpu_torch.experiments import exp_gather as eg
    from e2fgvi_tpu_torch.kernels import build, deform, gather
    from e2fgvi_tpu_torch.utils.timing import cuda_ms

    def timed(kernel, fn, lib_fn, **extra):
        print(json.dumps({"tag": tag, "kernel": kernel, **extra,
                          "ms": cuda_ms(fn, GATHER_ITERS),
                          "library_ms": cuda_ms(lib_fn, GATHER_ITERS),
                          "split": split(fn),
                          "library_split": split(lib_fn)}), flush=True)

    tab, idx, py, px = eg.make_inputs(dev)
    h, w = 60, 108
    with torch.inference_mode():
        for dt in ("float32", "bfloat16"):
            t = tab.to(getattr(torch, dt))
            e3 = lambda: gather.row_gather(t, idx)  # noqa: E731
            timed("row_gather", e3, cs.e3_library(t, idx), dtype=dt)
            saved[f"row_gather_{dt}"] = e3().cpu()
        e4 = lambda: gather.bilinear4_sample(tab, py, px, h, w)  # noqa: E731
        timed("bilinear4_sample", e4, cs.e4_library(tab, py, px, h, w))
        saved["bilinear4_sample"] = e4().cpu()
        flow1, flow2, _, xfeat = cs.k1k2_inputs(cs._randn_fn(dev),
                                                *SHAPES["base"])
        wflow = torch.cat([flow1, flow2], 0)
        timed("flow_warp", lambda: deform.flow_warp(xfeat, wflow),
              cs.k2_library(xfeat, wflow), dtype="float32")
        # the host part of the launch path every wrapper shares
        t1 = torch.randn((1, 8), device=dev)
        i1 = torch.zeros((1, 8), dtype=torch.int32, device=dev)
        pieces = {"stream_args": lambda: build.stream_args(t1),
                  "check_cuda_inputs": lambda: deform.check_cuda_inputs(
                      "x", t1, i1),
                  "row_gather_1_row": lambda: gather.row_gather(t1, i1)}
        print(json.dumps({"tag": tag, "kernel": "launch path", "host_us": {
            k: host_us(f) for k, f in pieces.items()}}), flush=True)
        torch.cuda.synchronize()


def k1_float64(x, head, flow_1, flow_2, weight, bias, max_residue=10.0,
               padding=1):
    """K1 (kernels/deform.py deform_conv_head_plain) of float32 inputs in
    float64 throughout: offsets, mask, sample positions, the bilinear
    samples and the contraction, one tap at a time. (N, Ho, Wo, Cout)
    float64."""
    import torch
    import torch.nn.functional as F
    x, head, f1, f2, wt, bias = (t.double() for t in (
        x, head, flow_1, flow_2, weight, bias))
    n, h, w, cin = x.shape
    cout, _, kh, kw = wt.shape
    _, ho, wo, ch = head.shape
    k = kh * kw
    g = ch // (3 * k)
    cg = cin // g
    # groups [0, G/2) ride flow_1; flows are (dx, dy), offsets (dy, dx)
    first = (torch.arange(g, device=x.device) < g // 2)[:, None, None]
    flow = torch.where(first, f1.flip(-1)[:, :, :, None, None, :],
                       f2.flip(-1)[:, :, :, None, None, :])
    off = max_residue * torch.tanh(head[..., :2 * k * g]).reshape(
        n, ho, wo, g, k, 2) + flow
    mask = torch.sigmoid(head[..., 2 * k * g:]).reshape(n, ho, wo, g, k)
    xg = x.reshape(n, h, w, g, cg).permute(0, 3, 4, 1, 2)
    xg = xg.reshape(n * g, cg, h, w)
    ys = torch.arange(ho, dtype=torch.float64, device=x.device)[:, None, None]
    xs = torch.arange(wo, dtype=torch.float64, device=x.device)[None, :, None]
    w4 = wt.reshape(cout, g, cg, k)
    out = bias.expand(n, ho, wo, cout).clone()
    for t in range(k):
        ky, kx = divmod(t, kw)
        py = ys - padding + ky + off[..., t, 0]          # (N, Ho, Wo, G)
        px = xs - padding + kx + off[..., t, 1]
        grid = torch.stack([2.0 * px / max(w - 1, 1) - 1.0,
                            2.0 * py / max(h - 1, 1) - 1.0], -1)
        grid = grid.permute(0, 3, 1, 2, 4).reshape(n * g, ho, wo, 2)
        samp = F.grid_sample(xg, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True).reshape(n, g, cg, ho, wo)
        samp = samp * mask[..., t].permute(0, 3, 1, 2)[:, :, None]
        out += torch.einsum("ngcyx,ogc->nyxo", samp, w4[..., t])
    return out


def run_accuracy(cs, tag, dev, saved):
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    for label, (b, h, w) in ACCURACY_SHAPES.items():
        flow1, flow2, (x, head, wt, bias), _ = cs.k1k2_inputs(
            cs._randn_fn(dev), b, h, w)
        args = (x, head, flow1, flow2, wt, bias)
        with torch.inference_mode():
            got = deform.modulated_deform_conv2d_head(*args).double()
            want = deform.deform_conv_head_plain(*args).double()
            ref = k1_float64(*args)
            print(json.dumps({
                "tag": tag, "shape": label, "kernel": "deform_conv float32",
                "kernel_vs_f64": float((got - ref).abs().max()),
                "plain_vs_f64": float((want - ref).abs().max()),
                "scale": float(ref.abs().max())}), flush=True)
        del args, x, head, got, want, ref
        torch.cuda.empty_cache()


def serve_runs(cs, tag, dev, dtype, max_batch, cases):
    """chip_smoke.serve with the golden weights of each (variant, videos,
    frames, (h, w)) case in `dtype`: one result line a video."""
    import torch
    from e2fgvi_tpu_torch.utils.timing import StageTimer
    for variant, n, t, (h, w) in cases:
        model = cs.golden_model(variant, dev).to(getattr(torch, dtype))
        torch.cuda.reset_peak_memory_stats()
        runs, _, _ = cs.serve(model, dev, n_videos=n, t=t,
                              timer_cls=StageTimer, max_batch=max_batch,
                              dtype=dtype, h=h, w=w)
        gib = torch.cuda.max_memory_allocated() / 2**30
        for i, r in enumerate(runs):
            print(json.dumps({"tag": tag, "serve": f"{variant} {w}x{h}",
                              "dtype": dtype, "video": i, **r,
                              "peak_gib": gib}), flush=True)
        del model
        torch.cuda.empty_cache()


def run_serve_f32(cs, tag, dev, saved):
    serve_runs(cs, tag, dev, "float32", 4, (("base", 2, 70, (240, 432)),
                                            ("hq", 1, 20, (480, 864))))


def run_serve_bf16(cs, tag, dev, saved):
    serve_runs(cs, tag, dev, "bfloat16", cs.B,
               (("base", 3, 70, (240, 432)), ("hq", 2, 70, (480, 864))))


def band_kernel_fn(qkv, pqkv, heads, window_size, expand_size):
    """A call of the E2 kernel alone on the qkv maps; in a tree before
    band_attention_kernel (the mma.sync kernel), its entry point with the
    arguments that tree's wrapper gives it."""
    import torch
    from e2fgvi_tpu_torch.kernels import band_attention as ba
    from e2fgvi_tpu_torch.kernels import build
    if hasattr(ba, "band_attention_kernel"):
        return lambda: ba.band_attention_kernel(qkv, pqkv, heads,
                                                window_size, expand_size)
    b, t, h, w, c3 = qkv.shape
    (wh, ww), c = window_size, c3 // 3
    offsets, n_fine = ba.slot_offsets(wh, ww, *expand_size)
    slots = torch.as_tensor(offsets, device=qkv.device)
    fv = torch.ones((b, t), dtype=torch.uint8, device=qkv.device)
    out = torch.empty((b * (h // wh) * (w // ww), t * wh * ww, c),
                      dtype=qkv.dtype, device=qkv.device)
    hd = c // heads

    def launch():
        build.check(build.library().e2fgvi_band_attention(
            qkv.data_ptr(), pqkv.data_ptr(), slots.data_ptr(),
            fv.data_ptr(), out.data_ptr(), b, t, h, w, heads, wh, ww,
            pqkv.shape[1], pqkv.shape[2], offsets.shape[0], n_fine, hd,
            float(hd ** -0.5), *build.stream_args(qkv)), "band_attention")
        return out
    return launch


def run_band_attention(cs, tag, dev, saved):
    import torch
    from e2fgvi_tpu_torch.experiments import exp_attn_band_r04 as ea
    from e2fgvi_tpu_torch.kernels import band_attention as ba
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    from e2fgvi_tpu_torch.models import tfocal
    from e2fgvi_tpu_torch.ops.convs import linear
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    block, x, pooled = ea.make_block(dev)
    attn = block.attn
    args = (attn, x, pooled, ea.HEADS, ea.WIN, ea.EXP)
    res = {"tag": tag, "shape": "base", "kernel": "band_attention"}
    with torch.inference_mode():
        qkv = linear(x, attn.qkv.weight, attn.qkv.bias).contiguous()
        pqkv = linear(pooled, attn.qkv.weight, attn.qkv.bias).contiguous()
        res["ms"] = cuda_ms(lambda: ba.band_attention(*args))
        res["kernel_ms"] = cuda_ms(band_kernel_fn(qkv, pqkv, *args[3:]))
        res["k3_layer_ms"] = cuda_ms(lambda: tfocal.window_attention(*args))
        saved["band_attention"] = ba.band_attention(*args).cpu()
        del qkv, pqkv
        make_inputs, _, _ = cs.k3_inputs(dev, *SHAPES["base"])
        k3_args = make_inputs(torch.bfloat16)
        res["k3_ms"] = cuda_ms(lambda: fa.focal_attention(*k3_args))
    print(json.dumps(res), flush=True)


def run_band_sampler(cs, tag, dev, saved):
    import torch
    from e2fgvi_tpu_torch.experiments import exp_dcn_inner_r04 as ei
    from e2fgvi_tpu_torch.experiments import exp_dcn_pack as ep
    from e2fgvi_tpu_torch.kernels import band_sampler as bs
    from e2fgvi_tpu_torch.utils.timing import cuda_ms

    def timed(shape, kernel, dtype, fn, ins, plain_ms=None):
        out = fn(*ins)
        bound, by = cs.roofline(ins[:4], [out], [
            (9 * out.numel(), cs.PEAK_FLOPS["float32"])])
        # the first two (batch, group) tiles, for --compare
        saved[f"{kernel}_{dtype}_{shape}"] = out[:2].cpu()
        del out
        res = {"tag": tag, "shape": shape, "kernel": kernel, "dtype": dtype,
               "ms": cuda_ms(lambda: fn(*ins), GATHER_ITERS),
               "bound_ms": bound, "bound_by": by,
               "split": split(lambda: fn(*ins), 50)}
        if plain_ms is not None:
            res["plain_ms"] = plain_ms
        print(json.dumps(res), flush=True)

    with torch.inference_mode():
        src, *pos = ei.make_inputs(dev)                  # band 24
        plain_ms = cuda_ms(lambda: bs.band_sample_plain(src, *pos), 3)
        src32 = src.float()
        timed("band24", "band_sample", "bfloat16", bs.band_sample,
              (src, *pos), plain_ms)
        timed("band24", "band_sample_cbatch", "bfloat16",
              bs.band_sample_cbatch, (src, *pos))
        timed("band24", "band_sample_xpair", "bfloat16",
              bs.band_sample_xpair, (bs.pack_xpairs(src), *pos))
        timed("band24", "band_sample", "float32", bs.band_sample,
              (src32, *pos))
        timed("band24", "band_sample", "base",
              lambda *a: bs.band_sample(*a, out_dtype=torch.bfloat16),
              (src32, *pos))
        timed("band24", "band_sample_cbatch", "float32",
              bs.band_sample_cbatch, (src32, *pos))
        del src, src32, pos
        torch.cuda.empty_cache()
        src, *pos = ep.make_inputs(dev)                  # band 48
        timed("band48", "band_sample", "bfloat16", bs.band_sample,
              (src, *pos),
              cuda_ms(lambda: bs.band_sample_plain(src, *pos), 3))
        timed("band48", "band_sample_cpair", "bfloat16",
              bs.band_sample_cpair, (bs.pack_cpairs(src), *pos))
        del src, pos
        torch.cuda.empty_cache()


def measure(root, tag, out_dir, parts):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from e2fgvi_tpu_torch.kernels import build
    from e2fgvi_tpu_torch.utils import env
    if not torch.cuda.is_available():
        raise SystemExit("deform_ab: CUDA is not available")
    env.setup()
    cs = chip_smoke()
    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"tag": tag, "root": root, "card": smi}), flush=True)
    lib, _ = build.build()
    build.library()
    kernels = [k for p in parts for k in SASS[p]]
    for k, c in cs.sass_histograms(lib, kernels).items():
        shown = {op: n for op, n in sorted(c.items())
                 if op.startswith(("LD", "ST", "HGMMA", "HMMA", "UTMA"))}
        print(json.dumps({"tag": tag, "sass": k, **cs.sass_digest(c),
                          "ops": shown}), flush=True)
    saved = {}
    runners = {"deform": run_deform, "gather": run_gather,
               "accuracy": run_accuracy, "serve_f32": run_serve_f32,
               "serve_bf16": run_serve_bf16,
               "band_attention": run_band_attention,
               "band_sampler": run_band_sampler}
    for p in parts:
        runners[p](cs, tag, dev, saved)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, f"{tag}.pt"))


def compare(a, b):
    import torch
    da, db = torch.load(a), torch.load(b)
    bars = chip_smoke().F32_MAX_ABS
    for k in sorted(set(da) & set(db)):
        d = (da[k].float() - db[k].float()).abs().max().item()
        same = torch.equal(da[k], db[k])
        res = {"compare": k, "bit_equal": same, "max_abs_diff": d}
        if k in TOLERANCE_OF:
            tol = bars[TOLERANCE_OF[k]]
            res.update(tolerance=tol, within=d <= tol)
        print(json.dumps(res), flush=True)


def _flat(prefix, d, out):
    for k, v in d.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k} ", v, out)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"{prefix}{k}"] = v


def _runs(paths):
    """{(tree, pair): {key: value}} from the first form's output files,
    each named <tree>_<pair>.jsonl: every number of every result line,
    keyed by the line's shape, dtype, kernel or serving run."""
    runs = {}
    for path in paths:
        tree, pair = os.path.basename(path).rsplit(".", 1)[0].rsplit("_", 1)
        vals = runs.setdefault((tree, int(pair)), {})
        with open(path) as f:
            for line in f:
                if not line.startswith("{"):
                    continue
                r = json.loads(line)
                if "sass" in r or "card" in r or "tag" not in r:
                    continue
                name = " ".join(str(r[k]) for k in (
                    "serve", "video", "shape", "kernel", "dtype") if k in r)
                _flat(f"{name}: ", {k: v for k, v in r.items()
                                    if k not in ("video",)}, vals)
    return runs


def summarize(paths):
    runs = _runs(paths)
    trees = sorted({t for t, _ in runs})
    for tree in trees:
        mine = {i: v for (t, i), v in runs.items() if t == tree}
        keys = sorted({k for v in mine.values() for k in v})
        vals = {k: [v[k] for v in mine.values() if k in v] for k in keys}
        print(json.dumps({"tree": tree, "runs": len(mine), **{
            stat: {k: f(x) for k, x in vals.items()} for stat, f in (
                ("median", statistics.median), ("min", min), ("max", max))}}),
            flush=True)
        wins = {}
        for k in keys:
            name, _, key = k.rpartition(": ")
            for ms, lib in LIBRARY_KEYS:
                if key == ms:
                    wins[f"{k} < {lib}"] = sum(
                        v[k] < v[f"{name}: {lib}"] for v in mine.values()
                        if k in v and f"{name}: {lib}" in v)
            # ms (a stage's too): lower is better; frames/s: higher
            sign = (1 if key.endswith(("ms", "ms_f32"))
                    or key.startswith("stages_ms")
                    else -1 if key == "fps" else 0)
            for other in trees if sign and "split" not in key else ():
                if other != tree:
                    wins[f"{k} {'<' if sign > 0 else '>'} {other}'s"] = sum(
                        sign * (v[k] - runs[(other, i)][k]) < 0
                        for i, v in mine.items()
                        if k in v and k in runs.get((other, i), {}))
        print(json.dumps({"tree": tree, "pairs": len(mine), "wins": wins}),
              flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=ROOT)
    p.add_argument("--tag", default="tree")
    # the saved outputs are ~0.3 GB: compare them on the card's machine
    p.add_argument("--out", default=os.path.join(ROOT, "build", "ab", "out"))
    p.add_argument("--parts", nargs="+", choices=sorted(SASS),
                   default=["deform", "gather"])
    p.add_argument("--compare", nargs=2)
    p.add_argument("--summarize", nargs="+", metavar="RUN.jsonl")
    args = p.parse_args(argv)
    if args.compare:
        compare(*args.compare)
    elif args.summarize:
        summarize(args.summarize)
    else:
        measure(args.root, args.tag, args.out, args.parts)


if __name__ == "__main__":
    main()
