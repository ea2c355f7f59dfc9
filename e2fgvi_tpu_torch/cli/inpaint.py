"""Single-video inpainting CLI on the GPU (the reference test.py contract).

Counterpart of e2fgvi_tpu/cli/inpaint.py: a frame directory or .mp4 in, a
per-frame mask directory, the neighbor/reference window flags, an .mp4
out. A reference checkpoint (.pth) loads into the port as it is, with
load_state_dict (no converter). The base model runs at 432x240; the HQ
model (--model e2fgvi_hq) at --width x --height with --set_size, else at
the video's own size.

    python -m e2fgvi_tpu_torch.cli.inpaint -v examples/tennis \
        -m examples/tennis_mask -c E2FGVI-CVPR22.pth --dtype bfloat16
    python -m e2fgvi_tpu_torch.cli.inpaint -v examples/hqtest \
        -m examples/hqtest_mask -c E2FGVI-HQ-CVPR22.pth --model e2fgvi_hq
"""

import argparse
import os
import time

import numpy as np
import torch

from e2fgvi_tpu_torch.utils import env


def build_parser():
    p = argparse.ArgumentParser(description="E2FGVI video inpainting "
                                "(PyTorch / CUDA)")
    p.add_argument("-v", "--video", type=str, required=True,
                   help="frame directory or .mp4")
    p.add_argument("-c", "--ckpt", type=str, required=True,
                   help="reference .pth checkpoint")
    p.add_argument("-m", "--mask", type=str, required=True,
                   help="directory of per-frame masks")
    p.add_argument("--model", type=str, default="e2fgvi",
                   choices=["e2fgvi", "e2fgvi_hq"])
    p.add_argument("--step", type=int, default=10, help="ref-frame stride")
    p.add_argument("--num_ref", type=int, default=-1)
    p.add_argument("--neighbor_stride", type=int, default=5)
    p.add_argument("--savefps", type=int, default=24)
    # the base model always runs at 432x240 and ignores these, as the JAX
    # CLI does; the HQ model takes (--width, --height) with --set_size
    p.add_argument("--set_size", action="store_true", default=False)
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--max_batch", type=int, default=4,
                   help="windows batched per forward")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default="results")
    p.add_argument("--random_weights", action="store_true",
                   help="smoke-test with seeded random weights")
    p.add_argument("--no_show", action="store_true",
                   help="accepted for the JAX CLI's flag set; this CLI "
                   "opens no result viewer")
    return p


def frame_size(args):
    """The (width, height) frames are read at, or None for the video's own
    size (e2fgvi_tpu/cli/inpaint.py:104-114): base is always 432x240, HQ
    takes (--width, --height) with --set_size."""
    if args.model == "e2fgvi":
        return (432, 240)
    if args.set_size:
        return (args.width, args.height)
    return None


def load_model(args, device):
    """The generator of args.model on `device` in args.dtype: seeded random
    weights with args.random_weights, else the reference .pth at
    args.ckpt. Returns (model, torch dtype)."""
    from e2fgvi_tpu_torch.models import e2fgvi
    model = e2fgvi.Generator("hq" if args.model == "e2fgvi_hq" else "base")
    if args.random_weights:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        e2fgvi.load_reference_state_dict(model, sd)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return model.to(device=device, dtype=dtype).eval(), dtype


def main(argv=None):
    args = build_parser().parse_args(argv)
    env.setup()
    device = env.device(args.device)
    # Pillow readers and the video writer are host-only modules of the
    # JAX package that import no jax
    from e2fgvi_tpu.data import readers
    from e2fgvi_tpu.data.video import write_video
    from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter

    size = frame_size(args)
    print(f"Loading frames from {args.video} ...")
    frames_pil = readers.read_frames(args.video, size)
    if size is None:
        size = frames_pil[0].size
    video_length = len(frames_pil)
    orig = np.stack([np.asarray(f, np.uint8) for f in frames_pil])
    print(f"Loading masks from {args.mask} ...")
    binary = np.stack(readers.read_masks_from_dir(args.mask, size))[..., None]

    model, dtype = load_model(args, device)
    runner = SlidingWindowInpainter(
        model, neighbor_stride=args.neighbor_stride, ref_length=args.step,
        num_ref=args.num_ref, max_batch=args.max_batch, dtype=dtype,
        out_dtype=np.uint8, device=device)

    print(f"Inpainting {video_length} frames at {size[0]}x{size[1]} "
          f"on {device} ...")
    t0 = time.time()
    comp = runner(orig, binary.astype(np.float32), orig, binary,
                  progress=lambda d, n: print(f"  windows {d}/{n}", end="\r"))
    dt = time.time() - t0
    print(f"\nDone in {dt:.2f}s ({video_length / dt:.2f} frames/s)")

    os.makedirs(args.out, exist_ok=True)
    base = os.path.basename(os.path.normpath(args.video))
    base = base.replace(".mp4", "") + "_results.mp4"
    out_path = write_video(os.path.join(args.out, base), comp,
                           fps=args.savefps)
    print(f"Saved: {out_path}")
    return out_path


if __name__ == "__main__":
    main()
