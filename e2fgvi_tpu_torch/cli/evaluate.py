"""Benchmark evaluation CLI on the GPU (the reference evaluate.py contract).

Counterpart of e2fgvi_tpu/cli/evaluate.py: the DAVIS / YouTube-VOS loop
with the reference protocol (evaluate.py:16-106): 432x240, neighbor stride
5, reference stride 10, dilated masks as both the model's mask and the
composite's, composite-then-metric, 50/50 overlap blend. Reports per-video
and average PSNR/SSIM and the dataset's VFID, and writes
<out>/<model>_<dataset>/<model>_<dataset>_metrics.txt in the reference
format; --save_results dumps the composited frames as PNGs.

The dataset reader (e2fgvi_tpu.data.datasets.TestDataset), PSNR/SSIM
(e2fgvi_tpu.eval.metrics) and the PNG writer are the JAX package's host
modules, imported as they are: none imports jax. VFID runs I3D on the
device at each video's exact length, as the reference does, and takes the
Frechet distance with eval/vfid.py; the JAX CLI's T-bucketing, which
exists because XLA compiles one program per shape, is not ported, so
--i3d_exact is the only mode.

    python -m e2fgvi_tpu_torch.cli.evaluate --dataset davis \\
        --data_root datasets --ckpt E2FGVI-CVPR22.pth \\
        --i3d_ckpt release_model/i3d_rgb_imagenet.pt
"""

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from e2fgvi_tpu_torch.utils import env


def build_parser():
    p = argparse.ArgumentParser(description="E2FGVI evaluation "
                                "(PyTorch / CUDA)")
    p.add_argument("--dataset", choices=["davis", "youtube-vos"],
                   required=True)
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--model", choices=["e2fgvi", "e2fgvi_hq"],
                   default="e2fgvi")
    p.add_argument("--ckpt", type=str, required=True,
                   help="reference .pth checkpoint")
    p.add_argument("--save_results", action="store_true", default=False)
    p.add_argument("--num_workers", type=int, default=4,
                   help="accepted for the JAX CLI's flag set; one host "
                   "thread decodes the next video ahead")
    p.add_argument("--i3d_ckpt", type=str,
                   default="release_model/i3d_rgb_imagenet.pt",
                   help="pytorch-i3d checkpoint; VFID is skipped (nan) "
                   "when it does not exist")
    p.add_argument("--i3d_exact", action="store_true", default=False,
                   help="accepted for the JAX CLI's flag set: I3D always "
                   "runs at each video's exact length here")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--random_weights", action="store_true",
                   help="smoke-test with seeded random weights")
    p.add_argument("--limit_videos", type=int, default=None)
    # the protocol size is 432x240 (reference evaluate.py:16); override
    # only for smoke tests
    p.add_argument("--width", type=int, default=432)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default="results")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    env.setup()
    device = env.device(args.device)
    from e2fgvi_tpu.data.datasets import TestDataset
    from e2fgvi_tpu.data.video import write_frames
    from e2fgvi_tpu.eval import metrics
    from e2fgvi_tpu_torch.cli.inpaint import load_model
    from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
    from e2fgvi_tpu_torch.eval.vfid import calculate_vfid
    from e2fgvi_tpu_torch.models import i3d

    dataset = TestDataset(args.data_root, args.dataset,
                          size=(args.width, args.height))
    if args.limit_videos:
        dataset.video_names = dataset.video_names[: args.limit_videos]

    model, dtype = load_model(args, device)
    runner = SlidingWindowInpainter(model, max_batch=args.max_batch,
                                    dtype=dtype, device=device)

    i3d_model = None
    if os.path.isfile(args.i3d_ckpt):
        i3d_model = i3d.load_i3d(args.i3d_ckpt, device)
    else:
        print(f"[warn] I3D checkpoint not found at {args.i3d_ckpt}; "
              "VFID will be skipped.")

    @torch.inference_mode()
    def features(video_u8):
        # uint8 to the device; the truncation is the reference's
        # (evaluate.py:122-123 builds PIL images from comp.astype(uint8))
        x = torch.from_numpy(np.ascontiguousarray(video_u8)).to(device)
        return i3d.i3d_features(i3d_model, x[None].float() / 255.0)[0].cpu()

    result_path = os.path.join(args.out, f"{args.model}_{args.dataset}")
    os.makedirs(result_path, exist_ok=True)
    all_psnr, all_ssim = [], []
    real_acts, fake_acts = [], []
    lines = []
    n_videos = len(dataset)
    t_start = time.time()
    total_frames = 0
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(dataset.__getitem__, 0) if n_videos else None
        for vi in range(n_videos):
            _, masks, name, orig = nxt.result()
            if vi + 1 < n_videos:
                nxt = pool.submit(dataset.__getitem__, vi + 1)
            comp = runner(orig, masks, orig, masks.astype(np.uint8))
            total_frames += len(comp)
            if i3d_model is not None:
                comp_u8 = np.stack(comp).astype(np.uint8)
                real_acts.append(features(orig).numpy().ravel())
                fake_acts.append(features(comp_u8).numpy().ravel())
            vals = [metrics.calc_psnr_and_ssim(gt.astype(np.float64),
                                               pred.astype(np.float64))
                    for gt, pred in zip(orig, comp)]
            v_psnr = [v[0] for v in vals]
            v_ssim = [v[1] for v in vals]
            all_psnr.extend(v_psnr)
            all_ssim.extend(v_ssim)
            line = (f"[{vi + 1:3}/{n_videos}] Name: {str([name]):25} | "
                    f"PSNR/SSIM: {np.mean(v_psnr):.4f}/"
                    f"{np.mean(v_ssim):.4f}")
            print(line)
            lines.append(line)
            if args.save_results:
                write_frames(os.path.join(result_path, name),
                             [c.astype(np.uint8) for c in comp])

    avg_psnr = float(np.mean(all_psnr))
    avg_ssim = float(np.mean(all_ssim))
    fid = (calculate_vfid(real_acts, fake_acts)
           if i3d_model is not None else float("nan"))
    dt = time.time() - t_start
    tail = ("Finish evaluation... Average Frame PSNR/SSIM/VFID: "
            f"{avg_psnr:.2f}/{avg_ssim:.4f}/{fid:.3f}")
    print(tail)
    print(f"[throughput] {total_frames / dt:.2f} frames/s end-to-end")
    with open(os.path.join(result_path,
                           f"{args.model}_{args.dataset}_metrics.txt"),
              "w") as summary:
        summary.write("".join(line + "\n" for line in lines) + tail)
    return avg_psnr, avg_ssim, fid


if __name__ == "__main__":
    main()
