"""The port's own host modules (data/readers, data/masks, data/video,
data/datasets, eval/metrics) against the JAX package's, on the same seeded
files: equal frames, masks, files and metrics, exactly."""

import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from chip_smoke import write_davis
from e2fgvi_tpu.data import datasets as jdatasets
from e2fgvi_tpu.data import masks as jmasks
from e2fgvi_tpu.data import readers as jreaders
from e2fgvi_tpu.data import video as jvideo
from e2fgvi_tpu.eval import metrics as jmetrics
from e2fgvi_tpu_torch.data import datasets, masks, readers, video
from e2fgvi_tpu_torch.eval import metrics

T, H, W = 5, 48, 80


def _frames(seed=0, t=T, h=H, w=W):
    """Smooth seeded uint8 RGB frames (h, w, 3)."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 255, (t, h // 8, w // 8, 3), dtype=np.uint8)
    return [np.asarray(Image.fromarray(f).resize((w, h), Image.BILINEAR))
            for f in low]


def _mask_dir(path, seed=1):
    """Per-frame mask PNGs: scattered blobs in 0/255 with a few grey
    pixels, which the > 0 binarization keeps."""
    rng = np.random.default_rng(seed)
    os.makedirs(path)
    for i in range(T):
        m = np.zeros((H, W), np.uint8)
        for _ in range(4):
            y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
            m[y:y + rng.integers(1, 8), x:x + rng.integers(1, 8)] = 255
        m[rng.integers(0, H, 6), rng.integers(0, W, 6)] = 7
        Image.fromarray(m).save(os.path.join(path, f"{i:05d}.png"))
    return path


def _as_arrays(frames):
    return np.stack([np.asarray(f) for f in frames])


@pytest.mark.parametrize("source", ["dir", "zip", "video"])
@pytest.mark.parametrize("size", [None, (64, 40)])
def test_read_frames_matches_jax(tmp_path, source, size):
    frames = _frames()
    if source == "dir":
        path = str(tmp_path / "frames")
        video.write_frames(path, frames)
        got, want = readers.read_frames(path, size), jreaders.read_frames(
            path, size)
        if size is None:
            np.testing.assert_array_equal(_as_arrays(got), np.stack(frames))
    elif source == "zip":
        path = str(tmp_path / "v.zip")
        with zipfile.ZipFile(path, "w") as zf:
            for i, f in enumerate(frames):
                jpg = str(tmp_path / f"{i}.jpg")
                Image.fromarray(f).save(jpg, quality=90)
                zf.write(jpg, arcname=f"{T - 1 - i:05d}.jpg")
        names = readers.ZipFrameReader.namelist(path)
        assert names == jreaders.ZipFrameReader.namelist(path)
        got = [readers.ZipFrameReader.imread(path, i) for i in range(T)]
        want = [jreaders.ZipFrameReader.imread(path, i) for i in range(T)]
        if size is not None:
            got = [f.resize(size) for f in got]
            want = [f.resize(size) for f in want]
    else:
        path = jvideo.write_video(str(tmp_path / "v.mp4"), frames)
        got, want = readers.read_frames(path, size), jreaders.read_frames(
            path, size)
    assert len(got) == len(want) == T
    np.testing.assert_array_equal(_as_arrays(got), _as_arrays(want))
    np.testing.assert_array_equal(
        readers.frames_to_array(got), jreaders.frames_to_array(want))


@pytest.mark.parametrize("iters", [0, 1, 4])
@pytest.mark.parametrize("size", [None, (64, 40)])
def test_read_masks_from_dir_matches_jax(tmp_path, iters, size):
    path = _mask_dir(str(tmp_path / "masks"))
    if size is None:
        size = (W, H)
    got = readers.read_masks_from_dir(path, size, iters)
    want = jreaders.read_masks_from_dir(path, size, iters)
    assert len(got) == T
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(readers.masks_to_array(got),
                                  jreaders.masks_to_array(want))
    # the numpy dilation equals the JAX package's dilation, native or not
    raw = (np.asarray(Image.open(os.path.join(path, "00000.png"))) > 0)
    np.testing.assert_array_equal(
        masks.dilate_cross(raw.astype(np.uint8), iters),
        jmasks.dilate_cross(raw.astype(np.uint8), iters))
    if iters:
        assert got[0].sum() > raw.sum()


@pytest.mark.parametrize("ext", [".avi", ".mp4", "mjpeg.mp4"])
def test_write_video_round_trip(tmp_path, ext):
    """The port's writer against the JAX package's: the same file where
    the container is the repo's own (MJPEG AVI, MJPEG-in-MP4), the same
    decoded frames where OpenCV writes it; the frames come back close to
    what was written."""
    frames = _frames(seed=2)
    mine, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    if ext == "mjpeg.mp4":
        video.write_mjpeg_mp4(mine, frames)
        jvideo.write_mjpeg_mp4(theirs, frames)
    else:
        mine = video.write_video(mine, frames)
        theirs = jvideo.write_video(theirs, frames)
    assert os.path.splitext(mine)[1] == os.path.splitext(theirs)[1]
    if ext != ".mp4":
        with open(mine, "rb") as f1, open(theirs, "rb") as f2:
            assert f1.read() == f2.read()
    if ext == ".avi":
        return      # no decoder for the repo's AVI here; equal bytes suffice
    got = _as_arrays(readers.read_frames(mine))
    np.testing.assert_array_equal(got,
                                  _as_arrays(jreaders.read_frames(theirs)))
    assert got.shape == (T, H, W, 3)
    assert np.abs(got.astype(float) - np.stack(frames)).mean() < 8.0


def test_write_frames_matches_jax(tmp_path):
    frames = _frames(seed=3)
    video.write_frames(str(tmp_path / "a"), frames)
    jvideo.write_frames(str(tmp_path / "b"), frames)
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert names == [f"{i:05d}.png" for i in range(T)]
    for n in names:
        assert (tmp_path / "a" / n).read_bytes() == \
            (tmp_path / "b" / n).read_bytes()
    np.testing.assert_array_equal(
        _as_arrays(readers.read_frames(str(tmp_path / "a"))),
        np.stack(frames))


@pytest.mark.parametrize("size", [(W, H), (64, 40)])
def test_test_dataset_matches_jax(tmp_path, size):
    root = write_davis(str(tmp_path), 2, T, H, W)
    mine = datasets.TestDataset(root, "davis", size=size)
    theirs = jdatasets.TestDataset(root, "davis", size=size)
    assert len(mine) == len(theirs) == 2
    assert mine.video_names == theirs.video_names
    for i in range(len(mine)):
        got, want = mine[i], theirs[i]
        assert got[2] == want[2]
        for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got[0].shape == (T, size[1], size[0], 3)
        assert got[1].sum() > 0


@pytest.mark.parametrize("case", ["noisy", "identical", "grey"])
def test_psnr_ssim_match_jax_exactly(case):
    rng = np.random.default_rng(4)
    a = np.stack(_frames(seed=5, t=1, h=96, w=128))[0].astype(np.float64)
    if case == "noisy":
        b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).round()
    elif case == "identical":
        b = a.copy()
    else:
        a, b = a[..., 0], np.clip(a[..., 0] + 3.0, 0, 255)
    got = metrics.calc_psnr_and_ssim(a, b)
    want = jmetrics.calc_psnr_and_ssim(a, b)
    assert got == want
    assert metrics.calculate_psnr(a, b) == jmetrics.calculate_psnr(a, b)
    assert metrics.calculate_ssim(a, b) == jmetrics.calculate_ssim(a, b)
    if case == "identical":
        assert got[0] == float("inf") and got[1] == pytest.approx(1.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_epe_matches_jax(dtype):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 40, 72, 2)).astype(dtype) * 4
    b = a + rng.standard_normal(a.shape).astype(dtype)
    got = metrics.calculate_epe(a, b)
    assert isinstance(got, float)
    assert got == jmetrics.calculate_epe(a, b)
    assert metrics.calculate_epe(a, a) == 0.0
    np.testing.assert_allclose(
        got, np.mean(np.hypot(*np.moveaxis(a.astype(np.float64) - b, -1, 0))),
        rtol=1e-6)
