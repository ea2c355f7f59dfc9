"""The port's evaluate CLI end to end on the CPU: a DAVIS-layout set of two
8-frame 216x120 videos, the HQ model with seeded random weights, and a
seeded I3D in the pytorch-i3d layout (logits head included)."""

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import write_davis
from e2fgvi_tpu_torch.cli import evaluate
from e2fgvi_tpu_torch.models import i3d

torch.set_num_threads(2)
T, H, W = 8, 120, 216


@pytest.fixture(scope="module")
def mini_davis(tmp_path_factory):
    """Two videos in the DAVIS layout of tests/test_evaluate_cli.py."""
    return write_davis(str(tmp_path_factory.mktemp("data")), 2, T, H, W)


def _argv(data_root, out, *extra):
    return ["--dataset", "davis", "--data_root", data_root, "--ckpt", "none",
            "--random_weights", "--model", "e2fgvi_hq", "--width", str(W),
            "--height", str(H), "--max_batch", "2", "--device", "cpu",
            "--out", str(out), *extra]


@pytest.mark.parametrize("n_videos", [2, 5, 40])
def test_vfid_matches_jax_package(n_videos):
    """The port's Frechet distance against e2fgvi_tpu.eval.metrics on the
    same features: rank-deficient covariances (fewer videos than the 1024
    features) as a small evaluation gives, and a set of 40."""
    from e2fgvi_tpu.eval import metrics
    from e2fgvi_tpu_torch.eval import vfid
    rng = np.random.default_rng(n_videos)
    real = [np.abs(rng.standard_normal(1024)) for _ in range(n_videos)]
    fake = [r + 0.1 * rng.standard_normal(1024) for r in real]
    want = metrics.calculate_vfid(real, fake)
    got = vfid.calculate_vfid(real, fake)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_evaluate_cli_with_vfid(mini_davis, tmp_path):
    ckpt = tmp_path / "i3d_rgb_imagenet.pt"
    torch.save(i3d.random_reference_state_dict(
        torch.Generator().manual_seed(0)), ckpt)
    psnr, ssim, vfid = evaluate.main(_argv(
        mini_davis, tmp_path / "results", "--i3d_ckpt", str(ckpt),
        "--save_results"))
    assert 5.0 < psnr < 60.0
    assert 0.0 < ssim <= 1.0
    assert np.isfinite(vfid)
    out = tmp_path / "results" / "e2fgvi_hq_davis"
    lines = (out / "e2fgvi_hq_davis_metrics.txt").read_text().splitlines()
    assert [ln.split("Name: ")[1].split()[0] for ln in lines[:2]] == \
        ["['vid0']", "['vid1']"]
    assert lines[-1].startswith(
        "Finish evaluation... Average Frame PSNR/SSIM/VFID: "
        f"{psnr:.2f}/{ssim:.4f}/{vfid:.3f}")
    for v in ("vid0", "vid1"):
        pngs = sorted((out / v).glob("*.png"))
        assert len(pngs) == T
        assert Image.open(pngs[0]).size == (W, H)


def test_evaluate_cli_without_i3d_skips_vfid(mini_davis, tmp_path, capsys):
    psnr, ssim, vfid = evaluate.main(_argv(
        mini_davis, tmp_path / "results", "--limit_videos", "1",
        "--i3d_ckpt", str(tmp_path / "absent.pt")))
    assert np.isnan(vfid)
    assert 5.0 < psnr < 60.0 and 0.0 < ssim <= 1.0
    out = capsys.readouterr().out
    assert "VFID will be skipped" in out
    assert "[throughput]" in out
