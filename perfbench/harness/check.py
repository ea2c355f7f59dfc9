"""The comparison that decides `correct` for served videos.

The plain reference (reference/) recomputes the composited frames of a
video from the same state dict, made anew from the seed, and the same
input arrays. Two numbers are compared, each against the cell's limit:

- worst_frame_mae: the largest, over the checked videos' frames, of a
  frame's mean absolute difference from the reference inside its mask,
  in 8-bit levels (a frame altered, or a window's output gone wrong,
  shows in its own frame and is not averaged away);
- outside_mask_diff: the largest absolute difference outside the mask,
  where the composite is the original frame: exact, limit 0.
"""

import contextlib

import numpy as np
import torch

from harness.weights import make_state_dict
from reference import model as ref_model
from reference import protocol

ROUND_TO = {"float8_e4m3fn": torch.float8_e4m3fn}


@contextlib.contextmanager
def tf32(on):
    """TF32 for float32 matmuls and cuDNN convolutions, on or off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_generator(variant, seed, device):
    with torch.device("meta"):
        g = ref_model.Generator(variant)
    g.load_state_dict(make_state_dict(variant, seed, device), strict=True,
                      assign=True)
    return g.eval()


def reference_video(g, config, traffic, video, device, precision=None):
    """The reference's composite of one (frames, masks) video. precision:
    None (float32, TF32 off), 'tf32', or a float8 type's name (both
    operands of every product rounded to it)."""
    frames, masks = video
    ops = ref_model.Ops(ROUND_TO.get(precision))
    # cuDNN off: PyTorch's own im2col + GEMM convolutions, independent of
    # the algorithms cuDNN picks for the program (some of its float32
    # picks run at 0.1 TFLOP/s here, which made the check longer than
    # the window)
    with tf32(precision == "tf32"), torch.backends.cudnn.flags(
            enabled=False):
        return protocol.inpaint(
            g, ops, frames, masks, frames, masks,
            np.dtype(traffic["out_dtype"]), device,
            config["neighbor_stride"], config["ref_length"],
            config["num_ref"])


def compare(got, want, binary):
    """(worst_frame_mae, outside_mask_diff) of one video's frames."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    inside = binary[..., 0] != 0
    diff = np.abs(got - want)
    worst = 0.0
    for d, m in zip(diff, inside):
        if m.any():
            worst = max(worst, float(d[m].mean()))
    outside = float(diff[~inside].max()) if (~inside).any() else 0.0
    return worst, outside


def compared(readings, limits):
    """{name: {value, limit}} from [(worst_frame_mae, outside)] readings."""
    return {"worst_frame_mae": {"value": max(r[0] for r in readings),
                                "limit": limits["worst_frame_mae"]},
            "outside_mask_diff": {"value": max(r[1] for r in readings),
                                  "limit": limits["outside_mask_diff"]}}


def passes(comp):
    return all(v["value"] <= v["limit"] for v in comp.values())


class ReferenceProgram:
    """The plain reference in the program's place, at a precision of its
    own: the control of a cell (its `check.control`), driven through a
    run like the program."""

    def __init__(self, cell, seed, device, precision=None):
        self.cell, self.device = cell, device
        self.precision = (cell["check"]["control"] if precision is None
                          else precision)
        self.g = reference_generator(cell["config"]["variant"], seed, device)

    def __call__(self, frames, masks, timer=None):
        out = reference_video(self.g, self.cell["config"],
                              self.cell["traffic"], (frames, masks),
                              self.device, self.precision)
        return list(out)
