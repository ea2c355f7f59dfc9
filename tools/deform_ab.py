#!/usr/bin/env python3
"""K1 and K2 of one tree of the port, timed apart, for A/B runs on one card.

    python3 tools/deform_ab.py --root <tree> --tag <name> [--out <dir>]
    python3 tools/deform_ab.py --compare <dir>/<a>.pt <dir>/<b>.pt

The first form imports e2fgvi_tpu_torch from <tree> (a checkout of any
commit of the port; its kernels build into <tree>/build) and times it with
that tree's utils.timing.cuda_ms, on chip_smoke.py's inputs
(chip_smoke.k1k2_inputs) at base (60x108 maps) and 864x480 (120x216), B=14,
in float32 and bfloat16:

- K1 whole (modulated_deform_conv2d_head), with chip_smoke.k1_gemm_and_peak:
  the contraction alone (cuBLAS on a random M x 2304 matrix), the float32
  im2col kernel alone (bfloat16 too in a tree whose bf16 K1 still writes
  an im2col matrix) and the peak device memory of one call;
- K2 on the pair of 128-channel feature warps (2B maps) beside
  F.grid_sample, and on the 2-channel flow composition (float32);
- K3 at base B=14;
- the SASS opcode histogram of the deform kernels and of the bf16 K3
  (cuobjdump): load and store opcodes in full, the rest as a digest.

It saves K1's and K2's base outputs to <dir>/<tag>.pt. The second form says
which saved outputs are bit-equal between two trees. Every result line is
JSON; the card's name and power limit come first.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"base": (14, 60, 108), "864x480": (14, 120, 216)}
KERNELS = ("deform_im2col_kernel", "flow_warp_kernel",
           "deform_conv_wgmma_kernel", "focal_attention_wgmma_kernel")


def chip_smoke():
    """This checkout's chip_smoke.py, whatever tree the package comes from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root, tag, out_dir):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from e2fgvi_tpu_torch.kernels import build, deform
    from e2fgvi_tpu_torch.kernels import focal_attention as fa
    from e2fgvi_tpu_torch.utils import env
    from e2fgvi_tpu_torch.utils.timing import cuda_ms
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
    for k, c in cs.sass_histograms(lib, KERNELS).items():
        shown = {op: n for op, n in sorted(c.items())
                 if op.startswith(("LD", "ST", "HGMMA", "UTMA"))}
        digest = hashlib.sha256(json.dumps(sorted(c.items())).encode())
        print(json.dumps({"tag": tag, "sass": k, "total": sum(c.values()),
                          "digest": digest.hexdigest()[:12], "ops": shown}),
              flush=True)

    saved = {}
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
    make_inputs, _, _ = cs.k3_inputs(dev, *SHAPES["base"])
    res = {"tag": tag, "shape": "base", "kernel": "focal_attention"}
    for dt in ("bfloat16", "float32"):
        args = make_inputs(getattr(torch, dt))
        with torch.inference_mode():
            res["ms" if dt == "bfloat16" else "ms_f32"] = cuda_ms(
                lambda: fa.focal_attention(*args))
        del args
    print(json.dumps(res), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, f"{tag}.pt"))


def compare(a, b):
    import torch
    da, db = torch.load(a), torch.load(b)
    for k in sorted(set(da) & set(db)):
        d = (da[k].float() - db[k].float()).abs().max().item()
        print(json.dumps({"compare": k, "bit_equal": torch.equal(da[k], db[k]),
                          "max_abs_diff": d}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=ROOT)
    p.add_argument("--tag", default="tree")
    # the saved outputs are ~0.3 GB: compare them on the card's machine
    p.add_argument("--out", default=os.path.join(ROOT, "build", "ab", "out"))
    p.add_argument("--compare", nargs=2)
    args = p.parse_args(argv)
    if args.compare:
        compare(*args.compare)
    else:
        measure(args.root, args.tag, args.out)


if __name__ == "__main__":
    main()
