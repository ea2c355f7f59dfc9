#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, evaluation and training paths
on one H100.

    python3 chip_smoke.py

(`chip_smoke.py --tp-worker <rank> <port> <dir> <batch>` is one model rank
of phase 9b, started by the script itself.)

Phases, one line each (any failed check raises and exits nonzero):
  1. device   CUDA with compute capability 9.0; nvidia-smi name, power limit
  2. build    nvcc builds the kernels in e2fgvi_tpu_torch/csrc; the SASS
              of K3 and K1 in both dtypes (one fused kernel each) must hold
              HGMMA (wgmma; TF32 ones in the float32 K1 and K3, which hold
              no HMMA) and UTMALDG (TMA loads); ptxas must report 0 spill
              bytes for the float32 K3 and E1; the bf16 K3's opcode
              histogram must be K3_SASS's (its consumer loop is shared
              with E2); E2 must hold HGMMA and LDGSTS (cp.async) and no
              HMMA (mma.sync), and csrc/flash_mma.cuh must be gone; the
              staged kernel of E5/E6 (band_staged_kernel) and of E1 (its
              CPair instantiation) must stage by LDGSTS or UTMALDG and
              read its corners by LDS (executable ones: cp.async's
              never-taken @!PT LDS padding does not count); C (its ten
              tap geometry and N-tile instantiations) must hold TF32 HGMMA
              and UTMALDG and no HMMA, and ptxas must report 0 spill
              bytes for it
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
              K3 also at B=1 with only the first frame valid, and at
              the 2 and 1 heads a rank runs at model_parallel 2 and 4
              (both dtypes, the same bars).
              Beside each kernel's ms: its plain version's, the one
              PyTorch call that computes the same function where there is
              one (library_ms: F.grid_sample for K2,
              scaled_dot_product_attention for K3), and its bound
              (bound_ms: bytes at 3.35 TB/s against operations at the
              H100 SXM's peak for their type)
  3b. conv    C, the float32 convolution kernel, through both entry
              points (check_conv): conv3x3 at feat_prop's six
              convolutions with their epilogues, on 60x108 maps at N = 4
              (timed) and N = 1, and on HQ's 120x216 at N = 1 (timed):
              against F.conv2d with TF32 off and float64, its bound at
              the 3xTF32 rate and at the FP32 rate, and as library_ms the
              best of cuDNN's float32 convolution in the port's NHWC call,
              on a contiguous NCHW tensor, and either under
              cudnn.benchmark (yardsticks the port never calls);
              raft_conv at RAFT's twelve update-block convolutions on
              848x480's 60x106 grid at N = 16 fields (timed) and 6, in the
              state buffer's channel ranges: against float64
              (C_MAX_ABS_F64), ms beside the conv_gemm path's (gemm_call:
              cuBLAS float32, TF32 off: plain_ms) and the bound at the
              3xTF32 rate (165 TFLOP/s); then one whole refine of 16
              fields (20 iterations, the benchmark's seeded RAFT) on C and
              on the conv_gemm path: ms, plain_ms, bound, the worst
              field's mean endpoint error between them
  3c. encoder C through encoder_conv (check_encoder) at the E2FGVI
              encoder's seven stride-1 convolutions, a grouped one a
              launch a group, on ENC_CHUNK (35) maps of 120x216 or 60x108:
              against float64 and cuDNN float32 (TF32 off), device ms by
              the profiler beside cuDNN's (the port's call before C), the
              bound at the 3xTF32 rate and the share; then one encoder
              call on 35 frames of 432x240 on C and on cuDNN
  4. golden   the generator in float32 with the kernels against
              tests/goldens/generator_base.npz
  5. serving  SlidingWindowInpainter (bfloat16, max_batch 14) on 3
              synthetic 70-frame 432x240 videos; launch counts; one window
              batch against the float32 plain path on the CPU; then 2 more
              videos at the inpaint CLI's defaults (float32, max_batch 4),
              the second warm, with their frames/s, stage split and launch
              counts (C's encoder launches: 18 an encoder call in float32,
              none in bfloat16)
  6. experiments  the seven kernels of the A/B experiments (E1-E6: banded
              sampler variants, row gather, 4-corner sampler,
              band-assembled attention) against their plain versions at
              the experiments' default shapes, E1/E6 bit-equal to E5, with
              bounds and library calls (torch.gather for E3, F.grid_sample
              for E4); then
              the four experiment entry points
              (e2fgvi_tpu_torch.experiments) with launch counts, and E2
              against K3 on one random block. E2 also alone (kernel_ms,
              kernel_bound_ms) beside K3's layer on the same inputs
              (k3_layer_ms), and within 5e-2 of the scale of its plain
              version and of K3's layer, with and without frame_valid, at
              the serving shape (B=14) and at 864x480 (40x72 tokens, 64
              windows, B=2)
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
  7b. propainter  K1's 8-channels-a-group form (Cin 128, 16 groups, K
              1152, max_residue 3) at B on 120x212 maps and K3 on the
              flagged rows of a sparse attention layer at B on the 40x71
              token grid over 20 frames (17 of 64 windows flagged an
              element; inputs captured from the layer, ~3.7k keys a row),
              both dtypes, against their plain versions with bounds,
              K1's gemm_ms and peak, K3's SDPA time; ProPainter serving
              (generator bfloat16, RAFT float32, max_batch 14) on 2
              synthetic 40-frame 848x480 videos under a moving ellipse,
              seeded weights: launch counts reset just before, the share
              of flagged rows, frames/s, stage split, peak memory; C's
              raft_conv launches, 202 a chunk of up to 16 fields
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
  9b. train tp  the same Trainer at model_parallel 2 (data 1 x model 2):
              its two model ranks as two processes of this script on the
              one card over gloo (NCCL refuses two ranks on one device),
              this process's cached memory released first; TP_STEPS steps
              on phase 9's data and seed against phase 9's first steps
              (both at batch 4 where 8 does not fit two ranks): losses
              within rtol 1e-4, the ranks' replicated weights bit-equal and
              their losses within rtol 1e-5 of each other, the generator
              and discriminator at the last step (the model_parallel 2
              checkpoint's full tensors) within TP_PARAM_BAR lr; per rank
              K3's calls by heads (2 each), K1-K3 launches, s/step (CUDA
              events) and peak GiB. Two ranks sharing one card say nothing
              of tensor parallelism's speed on two cards
Each phase prints its seconds. The second-to-last line is the kernels JSON;
the last line is {"ok": true, "device": {...}}. Weights are the goldens'
deterministic random weights and a seeded I3D; nothing is downloaded, and
JAX is never imported.
"""

import ast
import copy
import gc
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
PROPAINTER_MAP = (120, 212)    # ProPainter's quarter-res map at 848x480
PROPAINTER_TOKENS = (40, 71)   # ... and its token grid
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
           "focal_attention": (2e-4, 2e-4), "conv3x3": (1e-5, 1e-5),
           "band_sample": (1e-5, 1e-5), "band_sample_cbatch": (1e-5, 1e-5),
           "row_gather": (0.0, 0.0), "bilinear4_sample": (1e-6, 1e-6)}
# C (kernels/conv.py) lands within 3.5e-6 of float64 at feat_prop's
# shapes (outputs ~5), where cuDNN's float32 lands 1.4e-5 from it: its
# conv3x3 entry is held to 3e-5 of the plain form (cuDNN float32), and both
# entries' convolutions to C_MAX_ABS_F64 of float64; RAFT's refine on C to
# the conv_gemm path's flows (mean endpoint error, px)
F32_MAX_ABS = {"deform_conv": 2e-5, "focal_attention": 1e-5,
               "conv3x3": 3e-5}
C_MAX_ABS_F64 = 1e-5
C_MAX_EPE = 1e-4
BF16_REL = {"deform_conv": 2e-2, "flow_warp": 2e-2, "focal_attention": 5e-2,
            "band_sample": 2e-2, "band_sample_cbatch": 2e-2,
            "band_sample_xpair": 2e-2, "band_sample_cpair": 2e-2,
            "row_gather": 1e-6, "band_attention": 5e-2}
# the bound: an H100 SXM's published dense peaks (bf16 and TF32 on the
# tensor cores, float32 without them) and its memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
CSRC = "e2fgvi_tpu_torch/csrc/"
# the bf16 K3's SASS opcode histogram (opcodes with their modifiers) before
# its consumer loop moved to csrc/attention_wgmma.cuh, shared with E2:
# instructions and sass_digest (the parent tree's build, NVIDIA H100 80GB
# HBM3, CUDA toolkit of the card's machine)
K3_SASS = {"total": 1320, "digest": "e34515f45fb1"}
# C's kernel, conv_tf32::conv_tf32_kernel, by its mangled name
C_KERNEL = "9conv_tf3216conv_tf32_kernel"
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
    # C replaces no TPU kernel: the JAX package left feat_prop's
    # convolutions to XLA and has no RAFT
    "conv3x3": (CSRC + "conv.cu", None),
}


def log(msg):
    print(msg, flush=True)


def sass_histograms(lib, kernels, live=False):
    """{kernel: Counter of SASS opcodes with their modifiers} of the
    functions of the library `lib` whose names hold each of `kernels`
    (cuobjdump -sass); `live`: without the instructions predicated on
    @!PT, which never execute (ptxas pads cp.async with such LDS)."""
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
            if not (live and "@!PT " in line):
                hist[cur][m.group(1)] += 1
    return hist


def sass_counts(lib, kernel, opcodes, live=False):
    """How many SASS instructions of each opcode (any modifiers) the
    functions of the library `lib` whose names hold `kernel` have (`live`:
    as sass_histograms)."""
    hist = sass_histograms(lib, [kernel], live)[kernel]
    return {op: sum(n for full, n in hist.items()
                    if full == op or full.startswith(op + "."))
            for op in opcodes}


def ptxas_info(log, kernel):
    """[{"function", "registers", "spill_stores", "spill_loads"}] of each
    entry function in nvcc's ptxas -v output `log` whose name holds
    `kernel`."""
    import re
    res, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)} if kernel in m.group(1) else None
            if cur is not None:
                res.append(cur)
        elif cur is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line):
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            elif m := re.search(r"Used (\d+) registers", line):
                cur["registers"] = int(m.group(1))
    return res


def sass_digest(hist):
    """{"total", "digest"} of a sass_histograms Counter: its instruction
    count and a hash of its sorted (opcode, count) pairs."""
    import hashlib
    text = json.dumps(sorted(hist.items()))
    return {"total": sum(hist.values()),
            "digest": hashlib.sha256(text.encode()).hexdigest()[:12]}


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
    padding frames leave only the first frame valid, and at the 2 and 1
    heads a rank runs at model_parallel 2 and 4 (phase 9b), in both dtypes
    at the same bars."""
    res = check_k1k2(dev, b, h, w, timed, one_pass=True)
    res["focal_attention"], _ = check_k3(dev, b, h, w, t, timed)
    first, _ = check_k3(dev, 1, h, w, t, timed=False, pad="first")
    res["focal_attention"]["first_frame_only"] = first
    res["focal_attention"]["heads"] = {
        str(heads): check_k3(dev, b, h, w, t, timed=False, heads=heads)[0]
        for heads in (2, 1)}
    return res


# C's convolutions by entry point: name -> (epilogue, k), k how many of
# each one step runs. conv3x3: feat_prop's six (Cin, Cout in C3X3_SHAPES)
# in one propagation step of the backward pass; float32 serves at
# max_batch C_BATCH. raft_conv: RAFT's twelve (raft.update_operands'
# names) in one update iteration; the mask head's two run once a refine
C_CONVS = {
    "conv3x3": {"offset0": ("leaky", 1), "offset1": ("leaky", 2),
                "offset3": ("none", 1), "backbone0": ("leaky", 1),
                "backbone0_fwd": ("leaky", 0),
                "backbone1": ("residual", 1)},
    "raft_conv": {"convc1": ("relu", 1), "convc2": ("relu", 1),
                  "convf2": ("relu", 1), "conv": ("relu", 1),
                  "zr1": ("zr", 1), "q1": ("gru", 1), "zr2": ("zr", 1),
                  "q2": ("gru", 1), "fh1": ("relu", 1), "fh2": ("none", 1),
                  "mask0": ("relu", 0), "mask2": ("none", 0)}}
C3X3_SHAPES = {"offset0": (388, 128), "offset1": (128, 128),
               "offset3": (128, 432), "backbone0": (256, 128),
               "backbone0_fwd": (384, 128), "backbone1": (128, 128)}
C_BATCH = 4
RAFT_GRID = (60, 106)          # RAFT's 1/8 grid at 848x480


def conv_library(x, wt, b):
    """The best (ms, form) of cuDNN's float32 convolution (TF32 off) on x:
    in the port's call (ops.convs.conv2d: a channels-last view), on a
    contiguous NCHW copy, and either under cudnn.benchmark. Yardsticks the
    port never calls."""
    import torch
    import torch.nn.functional as F
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    xn = x.permute(0, 3, 1, 2)
    xc = xn.contiguous()
    best = []
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        try:
            for form, t in (("nhwc", xn), ("nchw", xc)):
                best.append((cuda_ms(lambda: F.conv2d(t, wt, b, padding=1)),
                             form + ("_benchmark" if bench else "")))
        finally:
            torch.backends.cudnn.benchmark = False
    return min(best)


def gemm_call(x, ops, act="none", out=None, net=None, z=None):
    """raft_conv's call with its convolution on raft.conv_gemm (pad, patch
    copy, cuBLAS float32 with TF32 off) and C's epilogue: the path C
    replaced in RAFT, the yardstick of RAFT's plain_ms and refine."""
    from e2fgvi_tpu_torch.kernels import conv
    from e2fgvi_tpu_torch.models import raft
    kh, kw = ops.weight.shape[2:]
    y = conv.epilogue(raft.conv_gemm(x, ops.weight, ops.bias, 1,
                                     (kh // 2, kw // 2)),
                      act=act, net=net, z=z)
    if act == "zr":
        zt, y = y
        z.copy_(zt)
    return y if out is None else out.copy_(y)


def raft_conv_args(randn, act, cin, n, h, w):
    """A covered convolution's inputs as raft.update hands them over: "zr"
    reads the state's [net, x] and writes r * net into it, "gru" reads
    [x, r * net] and writes over net; the others a contiguous map."""
    import torch
    from e2fgvi_tpu_torch.models import raft
    if act not in ("zr", "gru"):
        return {"x": randn(n, h, w, cin)}
    state = randn(n, h, w, raft.STATE)
    z = torch.sigmoid(randn(n, h, w, raft.HIDDEN_DIM))
    net = state[..., raft.NET]
    if act == "zr":
        return {"x": state[..., raft.HX], "out": state[..., raft.RNET],
                "net": net, "z": z}
    return {"x": state[..., raft.XR], "out": net, "net": net, "z": z}


def check_conv(dev, entry, n, h, w, timed=True):
    """C through `entry` at each of its convolutions (C_CONVS) on n maps
    of h x w, one launch each, against its plain form in float64
    (C_MAX_ABS_F64). conv3x3: random weights, feat_prop's epilogues, also
    against the plain form in float32 (cuDNN, TF32 off: F32_TOL,
    F32_MAX_ABS); raft_conv: RAFT's update block (PyTorch's default
    initialization, seed 0) in the state buffer's channel ranges. Timed:
    ms; plain_ms, the path C replaced (conv3x3: cuDNN float32; raft_conv:
    gemm_call); bound_ms, operations at the 3xTF32 rate, and share;
    conv3x3 also bound_ms_f32_fp32 (the FP32 rate) and library_ms
    (conv_library); and the sums over one step's convolutions, each k
    times (C_CONVS)."""
    import torch
    from e2fgvi_tpu_torch.kernels import conv
    from e2fgvi_tpu_torch.models import raft
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    if entry == "raft_conv":
        torch.manual_seed(0)
        raft_ops = raft.update_operands(raft.RAFT().update_block.to(dev))
    randn = _randn_fn(dev, seed=3 if entry == "conv3x3" else 7)

    def conv_bound(args, out, tf32=False):
        x, wt = args[0], args[1]
        flops = 2 * out.numel() * wt[0].numel()
        return roofline(args[:3], [out], [gemm_ops(flops, x, tf32)])

    res = {}
    for name, (act, _) in C_CONVS[entry].items():
        if entry == "conv3x3":
            cin, cout = C3X3_SHAPES[name]
            x = randn(n, h, w, cin)
            ops = conv.conv_operands(randn(cout, cin, 3, 3,
                                           std=(9 * cin) ** -0.5),
                                     randn(cout, std=0.1))
            r = randn(n, h, w, cout) if act == "residual" else None
            slope = 0.1 if act == "leaky" else None
            act = "none" if act == "residual" else act
            args = {"x": x, "residual": r}

            def call(x, wt, b, r):
                return conv.conv3x3(x, wt, b, negative_slope=slope,
                                    residual=r, operands=ops)
        else:
            ops, r, slope = raft_ops[name], None, None
            args = raft_conv_args(randn, act, ops.weight.shape[1], n, h, w)

            def call():
                return conv.raft_conv(ops=ops, act=act, **args)
        cout, cin, kh, kw = ops.weight.shape
        e = {"shape": [n, h, w, cin, cout, kh, kw], "act": act,
             "bn": ops.bn}
        # before the launch: "gru" writes over net
        ref = {k: v.double() for k, v in args.items()
               if k != "out" and v is not None}
        before = conv.LAUNCHES[entry]
        if entry == "conv3x3":
            inputs = (x, ops.weight, ops.bias, r)
            e.update(compare(
                "conv3x3", call, lambda x, wt, b, r: conv.conv_plain(
                    x, wt, b, r, act, slope), lambda dt: inputs, timed,
                ("float32",), bound_fn=conv_bound,
                tf32_bound_fn=lambda a, out: conv_bound(a, out, True)))
            got = call(*inputs)
        else:
            got = call()
        if conv.LAUNCHES[entry] == before:
            raise AssertionError(f"{entry} {name} did not launch C")
        want = conv.conv_plain(ref.pop("x"), ops.weight.double(),
                               ops.bias.double(), act=act,
                               negative_slope=slope, **ref)
        errs = []
        if act == "zr":
            wz, want = want
            errs.append(float((args["z"].double() - wz).abs().max()))
        errs.append(float((got.double() - want).abs().max()))
        e["max_abs_err_f64"] = max(errs)
        if not e["max_abs_err_f64"] <= C_MAX_ABS_F64:
            raise AssertionError(f"{entry} {name}: {errs} from float64 > "
                                 f"{C_MAX_ABS_F64}")
        del ref, want, got
        if timed and entry == "conv3x3":
            e["library_ms"], e["library"] = conv_library(x, ops.weight,
                                                         ops.bias)
        elif timed:
            e["ms"] = cuda_ms(call)
            e["plain_ms"] = cuda_ms(lambda: gemm_call(ops=ops, act=act,
                                                      **args))
            flops = 2 * n * h * w * cout * cin * kh * kw
            e["bound_ms"] = flops / (PEAK_FLOPS["tf32"] / 3) * 1e3
        if timed:
            e["share"] = e["bound_ms"] / e["ms"]
        res[name] = e
        del args, ops, r
        torch.cuda.empty_cache()
    out = {"n": n, "map": [h, w], "convs": res,
           "max_abs_err_f64": max(e["max_abs_err_f64"]
                                  for e in res.values())}
    if entry == "conv3x3":
        out["max_abs_err"] = max(e["max_abs_err"] for e in res.values())
    if timed:
        keys = ("ms", "plain_ms", "bound_ms") + (
            ("bound_ms_f32_fp32", "library_ms") if entry == "conv3x3"
            else ())
        for key in keys:
            out[key] = sum(res[name][key] * k
                           for name, (_, k) in C_CONVS[entry].items())
        out["bound_by"] = "operations"
        out["share"] = out["bound_ms"] / out["ms"]
    return out


def device_ms(fn, iters=5, launches=None):
    """(profiler ms, events ms) of one call of fn: the profiler's device
    self time of every operation over `iters` calls after a warm one,
    averaged (cuda_ms's events around one call hold the wrapper's host
    time); and CUDA events around `iters` calls back to back over iters,
    which hold only device time where the device is the slower side.
    launches: the kernel launches a call makes, where known; the
    profiler's sum is then averaged over the launches it recorded: on the
    H100 a session that follows one of cuDNN's FFT path (~25k launches a
    call) can miss its first launches (4 of 5 recorded, 9 of 10). Under
    the profiler cuDNN's FFT kernels also run 2-3x slower than the events
    read them."""
    import torch
    from e2fgvi_tpu_torch.utils import profiling
    fn()
    with profiling.trace() as table:
        for _ in range(iters):
            fn()
    if launches is not None:
        iters_seen = sum(r["calls"] for r in table["top"]) / launches
    else:
        iters_seen = iters
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return table["busy_ms"] / iters_seen, a.elapsed_time(b) / iters


def encoder_weights(enc, randn):
    """Seeded weights that keep the encoder's activations near unit scale:
    std (9 Cin_g)^-1/2, biases of 0.1."""
    import torch
    with torch.no_grad():
        for m in enc.layers[::2]:
            cout, cin = m.weight.shape[:2]
            m.weight.copy_(randn(cout, cin, 3, 3, std=(9 * cin) ** -0.5))
            m.bias.copy_(randn(cout, std=0.1))
    return enc


def check_encoder(dev):
    """C through encoder_conv at the E2FGVI encoder's seven stride-1
    convolutions (a grouped one a launch a group) on ENC_CHUNK maps of
    432x240's 120x216 (layer 1) or 60x108, seeded weights: each against
    float64 (C_MAX_ABS_F64) and cuDNN float32 with TF32 off, the port's
    call before C (ops.convs.conv2d, then LeakyReLU: F32_MAX_ABS
    ["conv3x3"]); device ms of each by the profiler (device_ms; by CUDA
    events beside it, events_ms) beside cuDNN's (library_ms,
    library_events_ms), the bound at the 3xTF32 rate and the share, and
    their sums; then one whole encoder call on ENC_CHUNK frames of 432x240
    on C and with every layer on cuDNN (encoder_ms, encoder_library_ms)."""
    import torch
    import torch.nn.functional as F
    from e2fgvi_tpu_torch.data.pipeline import ENC_CHUNK
    from e2fgvi_tpu_torch.kernels import conv
    from e2fgvi_tpu_torch.models import e2fgvi
    from e2fgvi_tpu_torch.ops.convs import conv2d, leaky_relu
    randn = _randn_fn(dev, seed=11)
    n, res = ENC_CHUNK, {}
    enc = encoder_weights(e2fgvi.Encoder().to(dev), randn)
    with torch.inference_mode():
        for i, (cin, cout, stride, groups) in enumerate(e2fgvi._ENC_PLAN):
            if stride != 1:
                continue
            h, w = (120, 216) if i == 1 else (60, 108)
            x = randn(n, h, w, cin)
            wt = randn(cout, cin // groups, 3, 3,
                       std=(9 * cin / groups) ** -0.5)
            b = randn(cout, std=0.1)
            ops = conv.group_operands(wt, b, groups)

            def c_call():
                return conv.encoder_conv(x, ops, 0.2)

            def cudnn():
                return leaky_relu(conv2d(x, wt, b, padding=1, groups=groups),
                                  0.2)
            before = conv.LAUNCHES["encoder"]
            got = c_call()
            if conv.LAUNCHES["encoder"] != before + groups:
                raise AssertionError(f"encoder layer {i}: not {groups} "
                                     f"launches")
            want64 = F.leaky_relu(F.conv2d(
                x.double().permute(0, 3, 1, 2), wt.double(), b.double(),
                padding=1, groups=groups), 0.2).permute(0, 2, 3, 1)
            e = {"shape": [n, h, w, cin, cout], "groups": groups,
                 "bn": ops[0].bn,
                 "max_abs_err": float((got - cudnn()).abs().max()),
                 "max_abs_err_f64": float((got.double() - want64).abs().max())}
            del got, want64
            if not (e["max_abs_err"] <= F32_MAX_ABS["conv3x3"]
                    and e["max_abs_err_f64"] <= C_MAX_ABS_F64):
                raise AssertionError(f"encoder layer {i}: {e}")
            e["ms"], e["events_ms"] = device_ms(c_call, launches=groups)
            e["library_ms"], e["library_events_ms"] = device_ms(cudnn)
            flops = 2 * n * h * w * cout * (cin // groups) * 9
            e["bound_ms"] = flops / (PEAK_FLOPS["tf32"] / 3) * 1e3
            e["share"] = e["bound_ms"] / e["ms"]
            res[f"layer{i}"] = e
            log(f"encoder_conv layer{i}: " + json.dumps(e))
            del x, ops
        out = {"n": n, "convs": res,
               **{key: sum(e[key] for e in res.values())
                  for key in ("ms", "events_ms", "library_ms",
                              "library_events_ms", "bound_ms")}}
        out["share"] = out["bound_ms"] / out["ms"]
        x = randn(n, 240, 432, 3)
        out["encoder_ms"], _ = device_ms(lambda: enc(x))
        enc.kernel_operands = lambda x: {}          # every layer on cuDNN
        out["encoder_library_ms"], _ = device_ms(lambda: enc(x))
        del enc, x
    torch.cuda.empty_cache()
    return out


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


def k1_bound(args, out, tf32=False):
    """K1's bound: the im2col GEMM on the tensor cores (float32: without
    them, or as three TF32 products) beside the sampler's ~9 float32
    operations per im2col element."""
    x, wt = args[0], args[4]
    cols = (out.numel() // out.shape[-1]) * wt[0].numel()
    return roofline(args, [out], [gemm_ops(2 * cols * out.shape[-1], x,
                                           tf32),
                                  (9 * cols, PEAK_FLOPS["float32"])])


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


def peak_mib(fn):
    """Peak device memory of one call of fn above what was allocated
    before it."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - before) / 2**20


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
        with torch.inference_mode():
            res["peak_mib" + sfx] = peak_mib(
                lambda: deform.modulated_deform_conv2d_head(
                    x, head, f1, f2, wt, bias))
        kdim = wt[0].numel()
        col = torch.randn((m, kdim), device=x.device).to(x.dtype)
        w_r = torch.randn((kdim, wt.shape[0]), device=x.device).to(x.dtype)
        res["gemm_ms" + sfx] = cuda_ms(lambda: col @ w_r)
        del col
    return res


def k3_inputs(dev, b, h, w, t=17, pad="serving", heads=4):
    """K3's inputs for b windows of T=t frames on the token grid of an
    h x w quarter-res map, with the real deduplicated key table and padding
    frames: pad "serving" pads frames 6-10, 9-10 and 15-16 of the first
    three windows, "first" every frame but the first. Each window's key
    panel is its own keys, then its gathered keys frame by frame (the order
    models/tfocal.py builds). heads: 4, or the 4/m a rank of
    model_parallel m runs. Returns (make_inputs(dtype), nwin, S)."""
    import torch
    from e2fgvi_tpu_torch.models import tfocal
    randn = _randn_fn(dev)
    hd, wh, ww = 128, 5, 9
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


def check_k3(dev, b, h, w, t=17, timed=True, pad="serving", chunked=False,
             heads=4):
    """K3 against its plain version (see k3_inputs), with its bound and
    SDPA's time; chunked runs the plain version one batch element at a
    time. Returns compare()'s result and the geometry (nwin, S)."""
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    make_inputs, nwin, s = k3_inputs(dev, b, h, w, t, pad, heads)
    return compare("focal_attention", fa.focal_attention,
                   fa.focal_attention_plain, make_inputs, timed,
                   bound_fn=k3_bound, library_fn=k3_library,
                   tf32_bound_fn=lambda a, out: k3_bound(a, out, True),
                   plain_chunks=k3_chunks if chunked else None), (nwin, s)


SERVING_KERNELS = ("deform", "focal_attention", "conv")
SERVING_NAMES = ("deform_conv", "flow_warp", "focal_attention")
EXPERIMENT_KERNELS = ("band_sampler", "gather", "band_attention")


def _counters(modules):
    import importlib
    return [importlib.import_module("e2fgvi_tpu_torch.kernels." + m).LAUNCHES
            for m in modules]


def launch_counts(modules=SERVING_KERNELS, skip=("raft_conv", "encoder")):
    """{entry point: launches} of the modules' counters but `skip`: by
    default C's RAFT entry point, which E2FGVI never runs, and its encoder
    entry point, which bfloat16 and training (grad mode) never run (serve
    reads it apart)."""
    return {k: v for d in _counters(modules) for k, v in d.items()
            if k not in skip}


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
    from e2fgvi_tpu_torch.data.pipeline import (ENC_CHUNK,
                                                SlidingWindowInpainter)
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
    # C takes feat_prop's float32 convolutions and the encoder's stride-1
    # ones (18 launches an encoder call of up to ENC_CHUNK frames);
    # bfloat16 bypasses it
    c1 = counts.pop("conv3x3")
    enc = launch_counts(skip=())["encoder"]
    calls = n_videos * -(-t // ENC_CHUNK)
    if not all(v > 0 for v in counts.values()) or (
            (c1 > 0) != (dtype == "float32")) or enc != (
            18 * calls if dtype == "float32" else 0):
        raise AssertionError(f"serving missed a kernel: {counts}, C "
                             f"{c1} and encoder {enc} in {dtype}")
    counts["conv3x3"], counts["encoder"] = c1, enc
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


def sparse_rows(flags, n_local, nv, nr, dev):
    """propainter.SparseRows of a window batch from (B, nwin) bool flags,
    every window with nv locals and nr references."""
    import torch
    from e2fgvi_tpu_torch.models import propainter
    b, nwin = flags.shape
    rows = np.arange(b * nwin).reshape(b, nwin)
    kfs, kvs = [], []
    for par in range(propainter.T_DILATION):
        k = propainter.key_frames(nv, nr, n_local, par)
        kf = torch.tensor([k] * int(flags.sum()), dtype=torch.long,
                          device=dev).reshape(int(flags.sum()), len(k))
        kfs.append(kf)
        kvs.append(torch.ones_like(kf, dtype=torch.bool))
    return propainter.SparseRows(
        torch.as_tensor(rows[flags], device=dev),
        torch.as_tensor(rows[~flags], device=dev), tuple(kfs), tuple(kvs))


def check_propainter_kernels(dev, t=20, n_local=11, flagged=17):
    """K1 and K3 as ProPainter's serving at 848x480 runs them, against
    their plain versions in both dtypes.

    K1: its 8-channels-a-group form (Cin 128, G 16, K 1152, flow_2 =
    flow_1, max_residue 3) at batch B on 120x212 maps. K3: the flagged
    rows of one sparse attention layer at batch B on the 40x71 token grid
    (64 windows once padded to 40x72) over t frames (n_local locals, then
    references), `flagged` of each element's 64 windows flagged, each
    element others; K3's inputs are those sparse_attention hands it (the
    queries of all t frames, the keys of the parity-1 key frames over the
    deduplicated key table), captured from the layer itself in each
    dtype; the plain version runs 16 rows at a time."""
    import torch
    from e2fgvi_tpu_torch.kernels import deform
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    from e2fgvi_tpu_torch.models import propainter
    randn = _randn_fn(dev)
    h, w = PROPAINTER_MAP
    flow = randn(B, h, w, 2, std=3.0)
    flow[:, :4, :, 1] -= 40.0
    base = (randn(B, h, w, 128), randn(B, h, w, 27 * 16),
            randn(128, 128, 3, 3, std=0.03), randn(128, std=0.1))

    def k1_inputs(dt):
        x, head, wt, bias = (v.to(dt) for v in base)
        return x, head, flow, flow, wt, bias

    res = {"deform_conv": compare(
        "deform_conv",
        lambda *a: deform.modulated_deform_conv2d_head(*a, max_residue=3.0),
        lambda *a: deform.deform_conv_head_plain(*a, 3.0), k1_inputs,
        bound_fn=k1_bound,
        tf32_bound_fn=lambda a, out: k1_bound(a, out, True))}
    res["deform_conv"].update(k1_gemm_and_peak(
        k1_inputs, ("float32", "bfloat16"), B * h * w))
    res["deform_conv"]["shape"] = [B, h, w, 128]
    del base, flow
    torch.cuda.empty_cache()

    torch.manual_seed(0)
    attn = propainter.SparseWindowAttention()
    for m in (attn.key, attn.query, attn.value, attn.proj):
        torch.nn.init.normal_(m.weight, std=512 ** -0.5)
    attn = attn.to(dev)
    lh, lw = PROPAINTER_TOKENS
    ph, pw = propainter.padded_grid(lh, lw)
    nwin = (ph // propainter.WINDOW[0]) * (pw // propainter.WINDOW[1])
    flags = np.zeros((B, nwin), bool)
    for i in range(B):
        flags[i, (5 * i + np.arange(min(flagged, nwin - 1))) % nwin] = True
    rows = sparse_rows(flags, n_local, n_local, t - n_local, dev)
    x = randn(B, t, lh, lw, 512)
    captured, orig = {}, propainter.focal_attention

    def capture(*args):
        captured[args[0].dtype] = args
        return orig(*args)

    propainter.focal_attention = capture
    try:
        with torch.inference_mode():
            for dt in (torch.float32, torch.bfloat16):
                propainter.sparse_attention(attn.to(dt), x.to(dt), rows, 1)
    finally:
        propainter.focal_attention = orig
    del x, attn
    torch.cuda.empty_cache()
    q, k = captured[torch.float32][:2]
    r = captured[torch.float32][4]

    def k3_rows(args):
        q, k, v, bias, r, heads = args
        n = 16
        return [(q[i * heads:(i + n) * heads], k[i * heads:(i + n) * heads],
                 v[i * heads:(i + n) * heads], bias[i:i + n],
                 min(n, r - i), heads) for i in range(0, r, n)]

    res["focal_attention"] = {
        "rows": r, "rows_share": r / (B * nwin), "T": t,
        "queries": q.shape[1], "keys": k.shape[1],
        **compare("focal_attention", fa.focal_attention,
                  fa.focal_attention_plain, lambda dt: captured[dt],
                  bound_fn=k3_bound, library_fn=k3_library,
                  tf32_bound_fn=lambda a, out: k3_bound(a, out, True),
                  plain_chunks=k3_rows)}
    del captured, q, k
    torch.cuda.empty_cache()
    return res


def propainter_models(dev, seed=0):
    """ProPainter's generator (bfloat16) and RAFT (float32) on the card
    with seeded weights: PyTorch's default initialization, every
    convolution's weight drawn again at std 0.5 / sqrt(fan-in), and the
    deformable alignments' weights (zeros by default) at std 0.02."""
    import torch
    from e2fgvi_tpu_torch.models import propainter, raft
    torch.manual_seed(seed)
    g, r = propainter.Generator(), raft.RAFT()
    for mod in list(g.modules()) + list(r.modules()):
        if isinstance(mod, torch.nn.Conv2d):
            torch.nn.init.normal_(mod.weight, std=0.5 / np.sqrt(
                mod.weight[0].numel()))
    for a in g.feat_prop_module.deform_align.values():
        torch.nn.init.normal_(a.weight, std=0.02)
    return (g.to(dev).to(torch.bfloat16).eval(),
            r.to(dev).float().eval())


def check_raft_refine(dev, n_pairs=8):
    """One refine of 2 n_pairs fields (the forward and backward fields of
    n_pairs pairs of smooth 848x480 frames that pan 5 px right and 3 px
    down a frame, as video_flows chunks them) with the benchmark's seeded
    RAFT weights, 20 iterations: on C and on the conv_gemm path (every
    covered convolution through gemm_call): ms, plain_ms, the bound of C's
    operations at the 3xTF32 rate, C's raft_conv launches, and each field's
    mean endpoint error between the two (worst within C_MAX_EPE); under
    "trace", the device operations of one warm video_flows over the same
    frames (the encoders, the volume and the refine)."""
    import torch
    import torch.nn.functional as F
    from e2fgvi_tpu_torch.kernels import conv
    from e2fgvi_tpu_torch.models import raft
    from e2fgvi_tpu_torch.utils.profiling import trace
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    bench = os.path.join(ROOT, "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness.weights_propainter import make_state_dicts
    r = raft.RAFT()
    r.load_state_dict(make_state_dicts(9876543210123, torch.device("cpu"))[
        "raft"], strict=True)
    r = r.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(11)
    t = n_pairs + 1
    low = torch.rand((1, 3, (480 + 3 * t) // 8 + 1, (848 + 5 * t) // 8 + 1),
                     generator=g, device=dev)
    big = F.interpolate(low, size=(480 + 3 * t, 848 + 5 * t),
                        mode="bilinear")[0]
    f = torch.stack([big[:, 3 * i: 3 * i + 480, 5 * i: 5 * i + 848]
                     for i in range(t)]).permute(0, 2, 3, 1) * 2 - 1
    with torch.inference_mode():
        fmap = raft.encode(r.fnet, f)
        net, inp = raft.context(r, f)
        k = n_pairs
        args = (torch.cat([fmap[:k], fmap[1:]]),
                torch.cat([fmap[1:], fmap[:k]]),
                torch.cat([net[:k], net[1:]]), torch.cat([inp[:k], inp[1:]]))
        before = conv.LAUNCHES["raft_conv"]
        got = raft.refine(r, *args)
        launches = conv.LAUNCHES["raft_conv"] - before
        ms = cuda_ms(lambda: raft.refine(r, *args), iters=5, warmup=1)
        orig = conv.raft_conv
        conv.raft_conv = gemm_call
        try:
            want = raft.refine(r, *args)
            plain_ms = cuda_ms(lambda: raft.refine(r, *args), iters=3,
                               warmup=1)
        finally:
            conv.raft_conv = orig
        with trace() as table:
            raft.video_flows(r, f)
    epe = (got - want).norm(dim=-1).mean(dim=(1, 2))
    ops = raft.update_operands(r.update_block)
    h, w = fmap.shape[1:3]
    fields = 2 * k
    flops = sum(2 * fields * h * w * op.weight[0].numel() * op.weight.shape[0]
                * (raft.ITERS if C_CONVS["raft_conv"][name][1] else 1)
                for name, op in ops.items())
    res = {"fields": fields, "map": [h, w], "iters": raft.ITERS,
           "launches": launches, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": flops / (PEAK_FLOPS["tf32"] / 3) * 1e3,
           "epe_px": [float(v) for v in epe],
           "flow_mean_px": float(want.norm(dim=-1).mean()), "trace": table}
    res["share"] = res["bound_ms"] / res["ms"]
    if launches != 10 * raft.ITERS + 2:
        raise AssertionError(f"refine launched C {launches} times")
    if not max(res["epe_px"]) <= C_MAX_EPE:
        raise AssertionError(f"refine on C: endpoint error {res['epe_px']} "
                             f"px from the conv_gemm path > {C_MAX_EPE}")
    return res


def serve_propainter(dev, n_videos=2, t=40, h=480, w=848,
                     ellipse=(200, 150, 150, 100)):
    """ProPainter serving: SlidingWindowInpainter (generator bfloat16,
    RAFT float32, max_batch B, uint8 out) on synthetic t-frame h x w
    videos, each masked by an ellipse (centre x, y and semi-axes:
    `ellipse`) moving (4, 2) px a frame, launch counts reset just before. Returns the runs (with the share of
    window rows that took the flagged attention) and the launch counts."""
    import torch
    from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
    from e2fgvi_tpu_torch.utils.timing import StageTimer
    g, r = propainter_models(dev)
    inpainter = SlidingWindowInpainter(
        g, max_batch=B, dtype=torch.bfloat16, out_dtype=np.uint8,
        device=dev, flow_model=r)
    yy, xx = np.mgrid[0:h, 0:w]
    cx, cy, ax, ay = ellipse
    videos = []
    for seed in range(1, n_videos + 1):
        frames, _ = synth_video(seed, t, h, w)
        masks = np.stack([((xx - cx - 4 * i) / ax) ** 2
                          + ((yy - cy - 2 * i) / ay) ** 2 <= 1.0
                          for i in range(t)])[..., None].astype(np.uint8)
        videos.append((frames, masks))
    reset_launch_counts()
    runs = []
    for frames, masks in videos:
        timer = StageTimer()
        t0 = time.perf_counter()
        comp = inpainter(frames, masks.astype(np.float32), frames, masks,
                         timer=timer)
        dt = time.perf_counter() - t0
        totals = timer.totals()
        comp = np.stack(comp)
        if comp.shape != frames.shape or comp.dtype != np.uint8:
            raise AssertionError(f"bad output {comp.shape} {comp.dtype}")
        outside = masks[..., 0] == 0
        if not np.array_equal(comp[outside], frames[outside]):
            raise AssertionError("output differs outside the mask")
        flagged = totals.get("attn_rows_flagged", 0)
        frame = totals.get("attn_rows_frame", 0)
        if not 0 < flagged < flagged + frame:
            raise AssertionError(f"attention rows: {flagged} flagged, "
                                 f"{frame} frame")
        stages = {k: v for k, v in totals.items()
                  if not k.startswith(("attn_rows", "raft_iterations"))}
        runs.append({"seconds": dt, "fps": t / dt, "stages_ms": stages,
                     "flagged_share": flagged / (flagged + frame)})
    counts = launch_counts(skip=())
    # the generator runs in bfloat16: conv3x3 (float32 only) is bypassed;
    # RAFT's update block runs on C, 202 launches a chunk of up to 16 fields
    c2 = n_videos * 202 * -(-(t - 1) // 8)
    if not all(counts[k] > 0 for k in SERVING_NAMES) or counts["conv3x3"] \
            or counts["raft_conv"] != c2:
        raise AssertionError(f"ProPainter serving launches {counts}, C "
                             f"{c2} expected")
    del inpainter, g, r
    torch.cuda.empty_cache()
    return runs, counts


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
    # remat recomputes every propagation step but the first, whose two
    # backbone convolutions a direction (C) are not checkpointed
    recomputed = dict(fwd, conv3x3=fwd["conv3x3"] - 4)
    if res["launches_remat_per_step"] != {k: float(v) for k, v in
                                          recomputed.items()}:
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
    res["base"]["save_dir"] = os.path.join(
        tmp, f"b{res['base']['batch']}")
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = train_card_vs_cpu(dev, root)
    torch.cuda.empty_cache()
    res["hq"] = train_hq(dev, root)
    torch.cuda.empty_cache()
    return res


# phase 9b, tensor parallelism: the base config at model_parallel 2, its
# two model ranks as two processes on the one card over gloo (NCCL refuses
# two ranks on one device), against phase 9's first TP_STEPS steps
TP_STEPS, TP_MODEL = 2, 2
# Adam with beta1 = 0 moves a parameter by at most lr at step 1 and
# lr sqrt((1 - 0.99^2) / 0.01) = 1.41 lr at step 2, so two runs whose
# gradients differ in rounding (a near-zero gradient's sign) can part by
# twice their sum after two steps: phase 9's two-Adam-step bar from step 0
TP_PARAM_BAR = 2 * (1 + ((1 - 0.99 ** 2) / 0.01) ** 0.5)


def tp_worker(rank, port, tmp, batch):
    """One model rank of phase 9b (chip_smoke.py --tp-worker <rank> <port>
    <tmp> <batch>): the Trainer at model_parallel 2 on phase 9's synthetic
    set under <tmp>, TP_STEPS steps saving at the last; writes
    <tmp>/tp_<rank>.json: losses, s/step (CUDA events), this process's
    peak GiB, K1-K3 launches, the heads K3 ran at (calls by heads), or
    {"oom": ...} where the card ran out of memory."""
    import collections
    import hashlib
    os.environ.update(E2FGVI_NUM_PROCESSES=str(TP_MODEL),
                      E2FGVI_PROCESS_ID=str(rank),
                      E2FGVI_COORDINATOR=f"127.0.0.1:{port}")
    import torch
    sys.path.insert(0, ROOT)
    from e2fgvi_tpu_torch.models import tfocal
    from e2fgvi_tpu_torch.parallel.tensor import shard_dim
    from e2fgvi_tpu_torch.train.trainer import Trainer
    from e2fgvi_tpu_torch.utils import env
    env.setup()
    out = os.path.join(tmp, f"tp_{rank}.json")
    heads = collections.Counter()
    attention = tfocal.focal_attention

    def counted(q, k, v, bias, b, h):
        heads[h] += 1
        return attention(q, k, v, bias, b, h)

    tfocal.focal_attention = counted
    cfg = train_config("train_e2fgvi.json", tmp, os.path.join(tmp, "tp"),
                       batch_size=batch, save_freq=TP_STEPS, log_freq=1,
                       model_parallel=TP_MODEL)
    try:
        tr = Trainer(cfg, device="cuda")
        starts, ends, logs = [torch.cuda.Event(enable_timing=True)], [], {}

        def on_step(it, lg):
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            logs[it] = {k: float(v) for k, v in lg.items()}
            starts.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        starts[0].record()
        tr.train(max_steps=TP_STEPS, on_step=on_step)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for name, p in tr.state.gen.named_parameters():
            if shard_dim(name) is None:
                digest.update(p.detach().cpu().numpy().tobytes())
        for p in tr.state.dis.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        res = {"rank": rank, "grid": [tr.grid.data, tr.grid.model],
               "replicated_sha256": digest.hexdigest(),
               "losses": logs,
               "step_s": [a.elapsed_time(b) / 1e3
                          for a, b in zip(starts, ends)],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launch_counts(),
               "k3_heads": dict(heads)}
        tr.close()
    except RuntimeError as e:       # OutOfMemoryError, or cuBLAS's
        if "out of memory" not in str(e) and "ALLOC_FAILED" not in str(e):
            raise
        res = {"oom": str(e)}
    with open(out, "w") as f:
        json.dump(res, f)


def release_cuda_memory():
    """Return this process's cached device memory to the card: the cached
    blocks, and cuBLAS's workspaces, which live in the caching allocator and
    keep the whole segment around them (after phase 9 one 64 MiB workspace
    held a 27.2 GiB segment)."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def run_tp_ranks(tmp, batch, timeout=600):
    """The TP_MODEL ranks of phase 9b as processes of this script, over
    gloo; stops them all when one fails or runs out of memory. Returns
    their results (tp_worker's), or None where one ran out of memory."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, E2FGVI_DIST_BACKEND="gloo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    for r in range(TP_MODEL):
        path = os.path.join(tmp, f"tp_{r}.json")
        if os.path.exists(path):
            os.remove(path)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--tp-worker", str(r), str(port), tmp,
                               str(batch)], env=env)
             for r in range(TP_MODEL)]
    results = [None] * TP_MODEL
    deadline = time.time() + timeout
    try:
        while any(r is None for r in results):
            for r, p in enumerate(procs):
                if results[r] is None and p.poll() is not None:
                    if p.returncode:
                        raise AssertionError(f"tp rank {r} exited with "
                                             f"{p.returncode}")
                    with open(os.path.join(tmp, f"tp_{r}.json")) as f:
                        results[r] = json.load(f)
                    if "oom" in results[r]:
                        log(f"train tp: rank {r} out of memory at batch "
                            f"{batch}: {results[r]['oom']}")
                        return None
            if time.time() > deadline:
                raise AssertionError(f"tp ranks still running after "
                                     f"{timeout} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return results


def train_tp(dev, tmp, base):
    """Phase 9b: the base config at model_parallel 2 (data 1 x model 2)
    for TP_STEPS steps, both ranks on the card, against the same steps at
    model_parallel 1 (phase 9's, or a run at batch 4 here where batch 8
    does not fit two ranks): the same data and seed, so losses within rtol
    1e-4, and the generator and discriminator at the last step within
    TP_PARAM_BAR lr (the m = 2 checkpoint holds full tensors). Each rank
    runs K3 at 2 heads: its calls by heads, launches, s/step and peak GiB
    per rank."""
    import torch
    from e2fgvi_tpu_torch.train.trainer import Trainer
    batch, ref_dir, ref_logs = base["batch"], base["save_dir"], base["losses"]
    res = {"batch": batch, "main_reserved_gib": release_cuda_memory()}
    ranks = run_tp_ranks(tmp, batch)
    if ranks is None and batch == 8:
        res["oom_batch8"] = True
        batch = res["batch"] = 4
        ranks = run_tp_ranks(tmp, batch)
        # model_parallel 1 at batch 4: phase 9's steps were at batch 8
        ref_dir = os.path.join(tmp, "ref_b4")
        cfg = train_config("train_e2fgvi.json", tmp, ref_dir,
                           batch_size=4, save_freq=TP_STEPS)
        tr = Trainer(cfg, device=dev)
        ref_logs = {}
        tr.train(max_steps=TP_STEPS, on_step=lambda it, lg: ref_logs.update(
            {it: {k: float(v) for k, v in lg.items()}}))
        tr.close()
        del tr
        torch.cuda.empty_cache()
    if ranks is None:
        raise AssertionError(f"train tp: out of memory at batch {batch}")
    for r in ranks:
        for it, lg in r["losses"].items():
            finite_logs(lg, f"train tp rank {r['rank']} step {it}")
    # the replicated weights stay equal on the ranks (their gradients are
    # averaged over the model ranks); the ranks' forwards of them may round
    # apart (cuDNN picks its algorithms by the memory free at the call), so
    # their losses are held to each other within rtol 1e-5
    if len({r["replicated_sha256"] for r in ranks}) != 1:
        raise AssertionError("the model ranks' replicated weights differ")
    ranks_rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                    for it, want in ranks[0]["losses"].items()
                    for got in (ranks[1]["losses"][it],) for k in want)
    if not ranks_rel <= 1e-5:
        raise AssertionError(f"the model ranks' losses differ by "
                             f"{ranks_rel}: {[r['losses'] for r in ranks]}")
    rel = 0.0
    for it in range(1, TP_STEPS + 1):
        got, want = ranks[0]["losses"][str(it)], ref_logs[it]
        if set(got) != set(want):
            raise AssertionError(f"tp step {it}: {got} vs {want}")
        rel = max(rel, *(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                         for k in want))
    if not rel <= 1e-4:
        raise AssertionError(f"tp losses off by {rel} (rtol 1e-4): "
                             f"{ranks[0]['losses']} vs {ref_logs}")
    lr = float(train_config("train_e2fgvi.json", tmp, None)["trainer"]["lr"])
    diff, above, total = 0.0, 0, 0
    for name in ("gen.pth", "dis.pth"):
        got = torch.load(os.path.join(tmp, "tp", str(TP_STEPS), name),
                         map_location="cpu", weights_only=True)
        want = torch.load(os.path.join(ref_dir, str(TP_STEPS), name),
                          map_location="cpu", weights_only=True)
        if {k: v.shape for k, v in got.items()} != {
                k: v.shape for k, v in want.items()}:
            raise AssertionError(f"tp {name}: not the full tensors")
        for k, v in want.items():
            if v.is_floating_point() and v.numel():
                d = (got[k] - v).abs()
                diff = max(diff, float(d.max()))
                above += int((d > 0.1 * lr).sum())
                total += v.numel()
    if not diff <= TP_PARAM_BAR * lr:
        raise AssertionError(f"tp parameters off by {diff} > "
                             f"{TP_PARAM_BAR} lr")
    for r in ranks:
        if set(r["k3_heads"]) != {str(4 // TP_MODEL)}:
            raise AssertionError(f"rank {r['rank']} ran K3 at heads "
                                 f"{r['k3_heads']}")
        if not all(v > 0 for v in r["launches"].values()):
            raise AssertionError(f"rank {r['rank']} missed a kernel: "
                                 f"{r['launches']}")
    res.update(losses_max_rel=rel, ranks_losses_max_rel=ranks_rel,
               params_max_abs=diff,
               params_max_abs_over_lr=diff / lr,
               params_above_lr_tenth=f"{above}/{total}",
               ranks=[{k: r[k] for k in ("rank", "grid", "step_s",
                                         "peak_gib", "launches", "k3_heads")}
                      for r in ranks])
    return res


# phase 10, token maps: at base B windows of T_pad 17 (bf16 serving's
# max_batch), in both dtypes; at 864x480 the same in bfloat16 and the
# inpaint CLI's float32 batch (max_batch 4). Bars: float32 max |delta|
# relative to the literal chain's largest value (the two forms sum the same
# float32 terms in other orders); bfloat16 relative to the float32 literal
# chain on the same rounded inputs, as bf16_rel_err is
TOKEN_MAPS = {"base": ("base", (H, W)), "864x480": ("hq", HQ_MAP)}
TOKEN_F32_WINDOWS = {"base": B, "864x480": 4}
TOKEN_F32_REL, TOKEN_BF16_REL = 2e-5, 2e-2


def subpixel_tokens_to_pixels(xt, weight, bias, output_size):
    """fold(linear(xt, weight, bias)) in the JAX package's sub-pixel form
    (e2fgvi_tpu/models/tfocal.py _tokens_to_pixels_conv): one dense 3x3
    convolution of the token grid to 9*cc channels, one per output phase,
    then depth-to-space; channel-last like tfocal._tokens_to_pixels. A
    yardstick for that function's transposed convolution, which the port
    runs; the port never calls this. Output row s*i + P takes kernel row
    s*d + P + p of token row i - d."""
    import torch
    import torch.nn.functional as F
    from e2fgvi_tpu_torch.models import tfocal
    from e2fgvi_tpu_torch.ops.patches import fold_bias
    (k, _), (s, _), (p, _) = (tfocal.T2T_KERNEL, tfocal.T2T_STRIDE,
                              tfocal.T2T_PADDING)
    reach = (k - 1 + p) // s                   # |d| <= 1 at 7/3/3
    taps = 2 * reach + 1
    ky = (s * (reach - torch.arange(taps))[None, :]
          + torch.arange(s)[:, None] + p)      # (phase, tap)
    ky = torch.where((ky >= 0) & (ky < k), ky, k).to(weight.device)
    c_in = xt.shape[-1]
    cc = weight.shape[0] // (k * k)
    wr = F.pad(weight.reshape(cc, k, k, c_in), (0, 0, 0, 1, 0, 1))
    wsub = wr[:, ky[:, None, :, None], ky[None, :, None, :]]
    wsub = wsub.permute(1, 2, 0, 5, 3, 4).reshape(s * s * cc, c_in, taps,
                                                  taps)
    z = F.conv2d(xt.permute(0, 3, 1, 2), wsub.to(xt.dtype), padding=reach)
    bt, _, lh, lw = z.shape
    z = z.permute(0, 2, 3, 1).reshape(bt, lh, lw, s, s, cc)
    z = z.permute(0, 1, 3, 2, 4, 5).reshape(bt, lh * s, lw * s, cc)
    z = z[:, :output_size[0], :output_size[1]].permute(0, 3, 1, 2)
    return z + fold_bias(bias.to(xt.dtype), output_size, tfocal.T2T_KERNEL,
                         tfocal.T2T_STRIDE, tfocal.T2T_PADDING)


def token_map_modules(variant, size, dev, seed=5):
    """Soft comp (base: the bias map of `size`; HQ: the bias conv) and one
    F3N at full width (512 hidden, 1960 = 40 x 49), seeded weights by the
    golden's rule."""
    import torch
    from e2fgvi_tpu_torch.models import tfocal
    sc = tfocal.SoftComp(128, 512, size if variant == "base" else None)
    mlp = tfocal.FusionFeedForward(512, 1960)
    rng = np.random.default_rng(seed)
    for m in (sc, mlp):
        m.load_state_dict({k: torch.from_numpy(fill_weight(
            k, tuple(v.shape), rng)) for k, v in m.state_dict().items()})
    return sc.to(dev), mlp.to(dev)


def check_token_maps(dev):
    """Phase 10: soft comp and the F3N feed-forward in their conv forms
    against their literal chains (Linear -> F.fold [-> F.unfold -> gelu ->
    Linear]) at TOKEN_MAPS' shapes in both dtypes: max |delta| within the
    bars, whether the output is contiguous, the ms of each form, one call's
    peak MiB each, and the token -> pixel map alone (t2p, a transposed
    convolution) beside the sub-pixel form (subpixel_tokens_to_pixels);
    for F3N also the form tfocal.fusion_feed_forward takes (the literal
    chain in float32, the conv form in bfloat16)."""
    import torch
    from e2fgvi_tpu_torch.models import tfocal
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    res = {}
    for label, (variant, size) in TOKEN_MAPS.items():
        sc32, mlp32 = token_map_modules(variant, size, dev)
        lh, lw = tfocal.token_grid(size)
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            b = B if dt == "bfloat16" else TOKEN_F32_WINDOWS[label]
            sc, mlp = (copy.deepcopy(m).to(dtype) for m in (sc32, mlp32))
            g = torch.Generator(device=dev).manual_seed(9)
            tok = torch.randn((b, 17, lh, lw, 512), generator=g,
                              device=dev).to(dtype)
            x = tok.reshape(b, -1, 512)
            cases = (
                ("soft_comp", tfocal.soft_comp, tfocal._soft_comp_literal,
                 sc, tok, sc.embedding),
                ("f3n", tfocal._fusion_feed_forward_conv,
                 tfocal._fusion_feed_forward_literal, mlp, x,
                 mlp.conv1[0]))
            for name, conv_fn, literal_fn, m, inp, lin in cases:
                r = {"frame_maps": b * 17}
                ref = copy.deepcopy(m).float()
                with torch.inference_mode():
                    got = conv_fn(m, inp, 17, size)
                    r["contiguous"] = got.is_contiguous()
                    if name == "f3n":
                        # the form the path takes: the literal chain in
                        # float32 on the card, the conv form otherwise
                        path = tfocal.fusion_feed_forward(m, inp, 17, size)
                        r["path"] = (
                            "conv" if torch.equal(path, got) else "literal"
                            if torch.equal(path, literal_fn(m, inp, 17, size))
                            else "neither")
                        if r["path"] != ("literal" if dt == "float32"
                                         and inp.is_cuda else "conv"):
                            raise AssertionError(f"token maps {label} {dt} "
                                                 f"f3n: path {r['path']}")
                        del path
                    # the float32 literal chain one window at a time: its
                    # 864x480 patch tensors would not fit whole
                    want = torch.cat([literal_fn(ref, inp[i: i + 1].float(),
                                                 17, size)
                                      for i in range(b)])
                    err = float((got.float() - want).abs().max())
                    r["max_abs_err"] = err
                    r["rel_err"] = err / float(want.abs().max())
                    del got, want
                    bar = r["bar"] = (TOKEN_BF16_REL if dt == "bfloat16"
                                      else TOKEN_F32_REL)
                    if not r["rel_err"] <= bar:
                        raise AssertionError(f"token maps {label} {dt} "
                                             f"{name}: {r}, bar {bar}")
                    if not r["contiguous"]:
                        raise AssertionError(f"token maps {label} {dt} "
                                             f"{name}: output not "
                                             "contiguous")
                    r["ms"] = cuda_ms(lambda: conv_fn(m, inp, 17, size))
                    r["literal_ms"] = cuda_ms(
                        lambda: literal_fn(m, inp, 17, size))
                    r["peak_mib"] = peak_mib(lambda: conv_fn(m, inp, 17,
                                                             size))
                    r["literal_peak_mib"] = peak_mib(
                        lambda: literal_fn(m, inp, 17, size))
                    xt = tok.reshape(b * 17, lh, lw, 512)
                    r["t2p_ms"] = cuda_ms(lambda: tfocal._tokens_to_pixels(
                        xt, lin.weight, lin.bias, size))
                    r["t2p_subpixel_ms"] = cuda_ms(
                        lambda: subpixel_tokens_to_pixels(
                            xt, lin.weight, lin.bias, size))
                res[f"{label} {dt} {name}"] = r
                del ref
                torch.cuda.empty_cache()
            del sc, mlp, tok, x
        del sc32, mlp32
        torch.cuda.empty_cache()
    return res


def trace_transformer(dev):
    """The device operations of one warm base bfloat16 window batch's
    transformer stage (soft split, the 8 blocks, soft comp: window_stage's
    `transformer` stage) on B windows of 17 frames of random features."""
    import torch
    from e2fgvi_tpu_torch.models import e2fgvi, tfocal
    from e2fgvi_tpu_torch.utils.profiling import trace
    model = golden_model("base", dev).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(3)
    feat = torch.randn((B, 17, H, W, 128), generator=g,
                       device=dev).to(torch.bfloat16)
    valid = torch.ones((B, 17), dtype=torch.bool, device=dev)

    def stage():
        tokens = tfocal.soft_split(model.ss, feat.reshape(B * 17, H, W, 128),
                                   B)
        tokens = tfocal.transformer_stack(
            model.transformer, tokens, (H, W), e2fgvi.NUM_HEADS,
            e2fgvi.WINDOW_SIZE, frame_valid=valid)
        return feat + tfocal.soft_comp(model.sc, tokens, 17,
                                       (H, W)).reshape(feat.shape)

    with torch.inference_mode():
        stage()
        with trace() as table:
            stage()
    del model
    torch.cuda.empty_cache()
    return table


def trace_train_step(dev, tmp):
    """The device operations of one warm step of configs/train_e2fgvi.json
    at its batch 8 (Trainer.train, data loading included) on a synthetic
    YouTube-VOS-layout set."""
    import torch
    from e2fgvi_tpu_torch.train.trainer import Trainer
    from e2fgvi_tpu_torch.utils.profiling import trace
    root = write_vos(tmp, TRAIN_VIDEOS, 20, 240, 432)
    cfg = train_config("train_e2fgvi.json", root, os.path.join(tmp, "ckpt"),
                       batch_size=8, save_freq=1000, log_freq=1000)
    tr = Trainer(cfg, device=dev)
    tr.train(max_steps=1)
    with trace() as table:
        tr.train(max_steps=1)
    tr.close()
    del tr
    torch.cuda.empty_cache()
    return table


def log_trace(label, table):
    log(f"trace {label}: wall {table['wall_ms']:.2f} ms, device busy "
        f"{table['busy_ms']:.2f} ms")
    for row in table["top"]:
        log(f"  {row['ms']:10.3f} ms {row['calls']:6d}x  {row['name'][:140]}")


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
    args = (block.attn, x, pooled, ea.HEADS, ea.WIN, ea.EXP)

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
        lambda dt: args, dtypes=("bfloat16",),
        bound_fn=band_attention_bound)
    res["band_attention"].update(check_band_attention(dev, args))
    return res, exact


def band_parity(args):
    """E2's layer against its plain version (float32, the same bf16
    inputs) and K3's layer, without and with frame_valid (the experiment's
    padding pattern, over the queries of valid frames): max |delta| over
    the plain version's scale, each below BF16_REL["band_attention"]."""
    import torch
    from e2fgvi_tpu_torch.experiments import exp_attn_band_r04 as ea
    from e2fgvi_tpu_torch.kernels import band_attention as ba
    from e2fgvi_tpu_torch.models import tfocal
    attn, x, pooled = args[:3]
    res = {}
    for sfx, fv in (("", None),
                    ("_fv", ea.frame_valid_mask(*x.shape[:2], x.device))):
        got = ba.band_attention(*args, frame_valid=fv)
        want = ba.band_attention_plain(attn, x.float(), pooled.float(),
                                       *args[3:], frame_valid=fv)
        k3 = tfocal.window_attention(*args, frame_valid=fv)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"band_attention{sfx}: non-finite output")
        if fv is None:
            fv = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        scale = float(want.float().abs().max())
        res["plain_rel" + sfx] = ea.valid_query_err(got, want, fv) / scale
        res["k3_rel" + sfx] = ea.valid_query_err(got, k3, fv) / scale
        del got, want, k3
    bar = BF16_REL["band_attention"]
    if not all(v < bar for v in res.values()):
        raise AssertionError(f"band_attention parity {res}, bar {bar}")
    return res


def check_band_attention(dev, args):
    """E2 beside compare(): the kernel alone (kernel_ms, on the qkv maps
    of the layer's GEMMs) against its bound (kernel_bound_ms: q.k and p.v
    over every window's T * S keys at the bf16 rate, against the maps'
    bytes), K3's layer on the same inputs (k3_layer_ms), and band_parity
    at the serving shape and at 864x480 (40x72 tokens, 64 windows, B=2)."""
    import torch
    from e2fgvi_tpu_torch.experiments import exp_attn_band_r04 as ea
    from e2fgvi_tpu_torch.kernels import band_attention as ba
    from e2fgvi_tpu_torch.models import tfocal
    from e2fgvi_tpu_torch.ops.convs import linear
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
    attn, x, pooled, heads, win, exp = args
    qkv = linear(x, attn.qkv.weight, attn.qkv.bias).contiguous()
    pqkv = linear(pooled, attn.qkv.weight, attn.qkv.bias).contiguous()
    res = {"kernel_ms": cuda_ms(lambda: ba.band_attention_kernel(
        qkv, pqkv, heads, win, exp)),
        "k3_layer_ms": cuda_ms(lambda: tfocal.window_attention(*args))}
    out = ba.band_attention_kernel(qkv, pqkv, heads, win, exp)
    nk = x.shape[1] * ba.slot_offsets(*win, *exp)[0].shape[0]
    flops = 4 * out.shape[0] * out.shape[1] * nk * out.shape[2]
    res["kernel_bound_ms"], res["kernel_bound_by"] = roofline(
        [qkv, pqkv], [out], [(flops, peak(x))])
    del qkv, pqkv, out
    torch.cuda.empty_cache()
    res["parity"] = {"serving": band_parity(args)}
    block, x2, pooled2 = ea.make_block(dev, b=2, h=HQ_MAP[0] // 3,
                                       w=HQ_MAP[1] // 3)
    res["parity"]["864x480"] = band_parity((block.attn, x2, pooled2,
                                            *args[3:]))
    return res


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
        if any(w in line for w in ("registers", "spill", "entry function",
                                   "wgmma")):
            log("  " + line.strip())
    # the float32 K3 and E1's staged kernel: none of their registers spill
    for kernel in ("focal_attention_3xtf32_kernel", "CPair"):
        info = ptxas_info(nvcc_log, kernel)
        log(f"ptxas {kernel}: {json.dumps(info)}")
        if not info or any(i.get("spill_stores", 1) or i.get("spill_loads", 1)
                           for i in info):
            raise AssertionError(f"{kernel}: spills or no ptxas report: "
                                 f"{info}")
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
    # the float32 K3: 3xTF32 on TF32 wgmma fed by TMA, no mma.sync left
    hist = sass_histograms(lib_path, ["focal_attention_3xtf32_kernel"])[
        "focal_attention_3xtf32_kernel"]
    ops = {op: n for op, n in hist.items()
           if op.startswith(("HGMMA", "UTMALDG", "HMMA"))}
    log(f"f32 K3 SASS opcodes: {json.dumps(ops)}")
    if not (any(op.startswith("HGMMA") and "TF32" in op for op in ops)
            and any(op.startswith("UTMALDG") for op in ops)) or any(
                op.startswith("HMMA") for op in ops):
        raise AssertionError(f"f32 K3 is not on TF32 wgmma + TMA alone: "
                             f"{ops}")
    # K3 keeps its SASS with the consumer loop it shares with E2; E2 runs
    # that loop on wgmma, fed by cp.async (LDGSTS), and mma.sync is gone
    hist = sass_histograms(lib_path, ["focal_attention_wgmma_kernel"])
    k3_sass = sass_digest(hist["focal_attention_wgmma_kernel"])
    log(f"bf16 K3 SASS histogram: {json.dumps(k3_sass)}")
    if k3_sass != K3_SASS:
        raise AssertionError(f"bf16 K3's SASS changed: {k3_sass} != "
                             f"{K3_SASS}: "
                             f"{json.dumps(hist['focal_attention_wgmma_kernel'])}")
    ops = sass_counts(lib_path, "band_attention_kernel",
                      ("HGMMA", "LDGSTS", "HMMA"))
    log(f"E2 SASS opcodes: {json.dumps(ops)}")
    if not (ops["HGMMA"] and ops["LDGSTS"]) or ops["HMMA"]:
        raise AssertionError(f"E2 is not on wgmma fed by cp.async: {ops}")
    # E5/E6 and E1: the band slab staged in shared memory by cp.async or
    # TMA, the corners read from there
    for label, kernel in (("E5/E6", "band_staged_kernel"), ("E1", "CPair")):
        ops = sass_counts(lib_path, kernel, ("LDGSTS", "UTMALDG", "LDS"),
                          live=True)
        log(f"{label} staged SASS opcodes: {json.dumps(ops)}")
        if not ((ops["LDGSTS"] or ops["UTMALDG"]) and ops["LDS"]):
            raise AssertionError(f"{label} does not stage its slab in "
                                 f"shared memory: {ops}")
    # C: 3xTF32 on TF32 wgmma fed by TMA, no mma.sync, no spills, in its
    # ten instantiations (the mangled name's length prefix keeps out K1's
    # deform_conv_tf32_kernel)
    info = ptxas_info(nvcc_log, C_KERNEL)
    log(f"ptxas conv_tf32_kernel: {json.dumps(info)}")
    if len(info) != 10 or any(i.get("spill_stores", 1) or
                             i.get("spill_loads", 1) for i in info):
        raise AssertionError(f"C: spills or no ptxas report: {info}")
    hist = sass_histograms(lib_path, [C_KERNEL])[C_KERNEL]
    ops = {op: n for op, n in hist.items()
           if op.startswith(("HGMMA", "UTMALDG", "HMMA"))}
    log(f"C SASS opcodes: {json.dumps(ops)}")
    if not (any(op.startswith("HGMMA") and "TF32" in op for op in ops)
            and any(op.startswith("UTMALDG") for op in ops)) or any(
                op.startswith("HMMA") for op in ops):
        raise AssertionError(f"C is not on TF32 wgmma + TMA alone: {ops}")
    csrc = os.path.join(ROOT, CSRC)
    if any("flash_mma" in name or "flash_mma" in open(
            os.path.join(csrc, name)).read() for name in os.listdir(csrc)):
        raise AssertionError("flash_mma is still in the kernel sources")
    t0 = phase_end("build", t0)

    # 3. kernels against their plain versions
    kres = check_kernels(dev)
    for name, r in kres.items():
        log(f"kernel {name}: " + json.dumps(r))
    torch.cuda.empty_cache()
    t0 = phase_end("kernels", t0)

    # 3b. conv: C through conv3x3 at feat_prop's convolutions and through
    # raft_conv at RAFT's covered convolutions and in one refine
    kres["conv3x3"] = check_conv(dev, "conv3x3", C_BATCH, H, W)
    check_conv(dev, "conv3x3", 1, H, W, timed=False)
    kres["conv3x3"]["hq"] = check_conv(dev, "conv3x3", 1, *HQ_MAP)
    log("kernel conv3x3: " + json.dumps(kres["conv3x3"]))
    rres = check_conv(dev, "raft_conv", 16, *RAFT_GRID)
    rres["n6"] = check_conv(dev, "raft_conv", 6, *RAFT_GRID,
                            timed=False)["max_abs_err_f64"]
    for name, r in rres["convs"].items():
        log(f"raft_conv {name}: " + json.dumps(r))
    rres["refine"] = check_raft_refine(dev)
    log_trace("raft video_flows, 9 frames 848x480 (one refine of 16 "
              "fields)", rres["refine"].pop("trace"))
    log("raft_conv refine: " + json.dumps(rres["refine"]))
    torch.cuda.empty_cache()
    t0 = phase_end("conv", t0)

    # 3c. encoder: C through encoder_conv at the encoder's stride-1 layers
    encres = check_encoder(dev)
    log("encoder_conv: " + json.dumps({k: v for k, v in encres.items()
                                       if k != "convs"}))
    t0 = phase_end("encoder", t0)

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

    # 7b. propainter: K1's 8-channels-a-group form and K3 on the flagged
    # rows at ProPainter's 848x480 shapes; ProPainter serving there
    pres = check_propainter_kernels(dev)
    for name, r in pres.items():
        log(f"propainter kernel {name}: " + json.dumps(r))
    torch.cuda.reset_peak_memory_stats()
    pruns, pcounts = serve_propainter(dev)
    log_runs("propainter serving 848x480", pruns)
    log(f"propainter serving launches {json.dumps(pcounts)}, flagged rows "
        + ", ".join(f"{r['flagged_share']:.3f}" for r in pruns)
        + f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    t0 = phase_end("propainter", t0)

    # 8. evaluate: the benchmark-evaluation entry point with VFID
    with tempfile.TemporaryDirectory() as tmp:
        eval_res, vcounts = run_evaluate(dev, tmp)
    log(f"evaluate: {json.dumps(eval_res)}, launches {json.dumps(vcounts)}")
    t0 = phase_end("evaluate", t0)

    # 9. train: the Trainer on the base config, resume, card vs CPU, HQ;
    # 9b. train tp: model_parallel 2, two ranks on the card, against
    # phase 9's steps (its checkpoint and the synthetic set, in tmp)
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
        tp = train_tp(dev, tmp, base)
    log("train tp: " + json.dumps(tp))
    for r in tp["ranks"]:
        log(f"train tp rank {r['rank']} batch {tp['batch']}: s/step "
            + ", ".join(f"{x:.3f}" for x in r["step_s"])
            + f"; peak {r['peak_gib']:.2f} GiB; launches "
            f"{json.dumps(r['launches'])}; K3 calls by heads "
            f"{json.dumps(r['k3_heads'])}")
    t0 = phase_end("train tp", t0)

    # 10. token maps: the conv forms of soft comp and F3N against their
    # literal chains; where the transformer's and a training step's device
    # time goes
    for name, r in check_token_maps(dev).items():
        log(f"token maps {name}: " + json.dumps(r))
    log_trace("transformer stage, base bf16 window batch",
              trace_transformer(dev))
    with tempfile.TemporaryDirectory() as tmp:
        log_trace("train step, base batch 8", trace_train_step(dev, tmp))
    t0 = phase_end("token maps", t0)
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
    e2_keys = ("kernel_ms", "kernel_bound_ms", "kernel_bound_by",
               "k3_layer_ms", "parity")
    c_keys = ("convs", "hq", "share", "max_abs_err_f64", "n", "map")
    extra = ("ms_f32", "plain_ms_f32", "bound_ms_f32", "bound_ms_f32_fp32",
             "library_ms_f32", "bf16_rel_err", "heads", *k1_keys, *e2_keys,
             *c_keys)
    hq_keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ms_f32",
               "plain_ms_f32", "bound_ms_f32", "bound_ms_f32_fp32",
               "library_ms_f32",
               "max_abs_err", "bf16_rel_err", f"b{B}", *k1_keys)
    for name, (src, replaces) in REPLACES.items():
        r = kres[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": counts[name],
                 "launches_train": base["launches"].get(name, 0),
                 "launches_train_tp_per_rank": [
                     r["launches"].get(name, 0) for r in tp["ranks"]],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"],
                 "library_ms": r.get("library_ms"),
                 **{k: r[k] for k in extra if k in r}}
        if name == "conv3x3":         # bf16 serving bypasses C
            entry["launches_f32_serving"] = counts32[name]
        if name in SERVING_NAMES:     # the HQ shapes' numbers (phase 7)
            entry["hq"] = {label: {k: v for k, v in hres[label][name].items()
                                   if k in hq_keys}
                           for label in hres}
            entry["launches_propainter"] = pcounts[name]
        if name in pres:              # ProPainter's shapes (phase 7b)
            entry["propainter"] = {
                k: v for k, v in pres[name].items()
                if k in (*hq_keys, "shape", "rows", "rows_share", "T",
                         "queries", "keys")}
        kernels.append(entry)
    kernels.append({
        "name": "raft_conv", "route": "cuda", "source": CSRC + "conv.cu",
        "replaces": None, "launches_propainter": pcounts["raft_conv"],
        "max_abs_err_f64": max(rres["max_abs_err_f64"], rres["n6"]),
        **{k: rres[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "share", "n", "map", "convs", "refine")}})
    kernels.append({
        "name": "encoder_conv", "route": "cuda", "source": CSRC + "conv.cu",
        "replaces": None, "launches_f32_serving": counts32["encoder"],
        "max_abs_err": max(e["max_abs_err"]
                           for e in encres["convs"].values()),
        "max_abs_err_f64": max(e["max_abs_err_f64"]
                               for e in encres["convs"].values()),
        **{k: encres[k] for k in ("ms", "events_ms", "library_ms",
                                  "bound_ms", "share", "n", "encoder_ms",
                                  "encoder_library_ms", "convs")}})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  int(sys.argv[5]))
    else:
        main()
