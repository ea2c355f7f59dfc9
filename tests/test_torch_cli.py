"""The port's inpaint CLI end to end on the CPU: a reference-layout .pth
(with the buffers a released checkpoint carries) in, an mp4 out."""

import ast
import os

import numpy as np
import torch

from e2fgvi_tpu_torch.cli import inpaint
from test_generator_golden import fill_weight

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_inpaint_cli_writes_video(tmp_path):
    data = np.load(os.path.join(ROOT, "tests", "goldens",
                                "generator_base.npz"))
    keys = [str(k) for k in data["keys"]]
    shapes = [ast.literal_eval(str(s)) for s in data["shapes"]]
    rng = np.random.default_rng(7)
    sd = {k: torch.from_numpy(fill_weight(k, s, rng))
          for k, s in zip(keys, shapes)}
    sd["update_spynet.mean"] = torch.zeros(1, 3, 1, 1)
    sd["transformer.0.attn.valid_ind_rolled"] = torch.zeros(
        8, dtype=torch.long)
    ckpt = tmp_path / "E2FGVI-CVPR22.pth"
    torch.save(sd, ckpt)

    out = inpaint.main([
        "-v", os.path.join(ROOT, "examples", "mini"),
        "-m", os.path.join(ROOT, "examples", "mini_mask"),
        "-c", str(ckpt), "--device", "cpu", "--max_batch", "3",
        "--out", str(tmp_path / "results")])
    assert os.path.getsize(out) > 0
