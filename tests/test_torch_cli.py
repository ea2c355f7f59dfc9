"""The port's inpaint CLI end to end on the CPU: a reference-layout .pth
(with the buffers a released checkpoint carries) in, an mp4 out; and its
result viewer, shown unless --no_show is given."""

import ast
import os
import sys

import numpy as np
import pytest
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
        "--out", str(tmp_path / "results"), "--no_show"])
    assert os.path.getsize(out) > 0


def _frames(n=3):
    from PIL import Image
    arr = np.random.default_rng(0).integers(0, 255, (n, 6, 8, 3),
                                            dtype=np.uint8)
    return [Image.fromarray(a) for a in arr], list(arr[::-1])


def test_show_results_returns_the_animation(tmp_path):
    """Under matplotlib's Agg backend the viewer builds the side-by-side
    animation (plt.show does nothing there); saving it draws every
    frame through its update function."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation
    frames, comp = _frames()
    plt.close("all")        # the viewer's figure is found again by its name
    try:
        anim = inpaint.show_results(frames, comp)
        assert isinstance(anim, animation.FuncAnimation)
        assert [ax.get_title() for ax in plt.gcf().axes] == [
            "Original Video", "Our Result"]
        anim.save(tmp_path / "result.gif", writer="pillow")
        assert os.path.getsize(tmp_path / "result.gif") > 0
    finally:
        plt.close("all")


def test_show_results_without_matplotlib(monkeypatch):
    for name in ("matplotlib", "matplotlib.pyplot", "matplotlib.animation"):
        monkeypatch.setitem(sys.modules, name, None)
    assert inpaint.show_results(*_frames()) is None


class _Echo:
    """Stands in for SlidingWindowInpainter: returns the input frames."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, frames, masks, orig, binary, progress=None):
        return list(orig)


@pytest.mark.parametrize("no_show", [False, True])
def test_inpaint_cli_shows_unless_no_show(monkeypatch, tmp_path, no_show):
    from e2fgvi_tpu_torch.data import pipeline
    shown = []
    monkeypatch.setattr(pipeline, "SlidingWindowInpainter", _Echo)
    monkeypatch.setattr(inpaint, "load_model",
                        lambda args, device: (None, torch.float32))
    monkeypatch.setattr(inpaint, "show_results",
                        lambda frames, comp: shown.append(len(comp)))
    inpaint.main(["-v", os.path.join(ROOT, "examples", "mini"),
                  "-m", os.path.join(ROOT, "examples", "mini_mask"),
                  "-c", "none", "--device", "cpu", "--out",
                  str(tmp_path)] + (["--no_show"] if no_show else []))
    assert shown == ([] if no_show else [12])
