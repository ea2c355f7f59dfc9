"""Host-side frame and mask reading: zip archives, frame directories, video
files, dataset manifests.

The port's own copy of the JAX package's readers (e2fgvi_tpu/data/
readers.py; reference core/utils.py:32-85 and test.py:57-94). Decoding is
PIL; an mp4 goes through OpenCV's VideoCapture (the reference's own path),
else an imageio ffmpeg/pyav backend.
"""

import io
import json
import os
import threading
import zipfile

import numpy as np
from PIL import Image

from e2fgvi_tpu_torch.data.masks import binarize_and_dilate


class ZipFrameReader:
    """Cached-handle zip reader; one handle per (path, process).

    Thread-safe (a lock guards the handle cache), unlike the reference's
    class-level dict which relied on process-based loader workers.
    """

    _cache: dict = {}
    _lock = threading.Lock()

    @classmethod
    def _open(cls, path):
        key = (os.getpid(), path)
        with cls._lock:
            zf = cls._cache.get(key)
            if zf is None:
                zf = zipfile.ZipFile(path, "r")
                cls._cache[key] = zf
            return zf

    @classmethod
    def namelist(cls, path):
        names = [n for n in cls._open(path).namelist()
                 if not n.endswith("/")]
        names.sort()
        return names

    @classmethod
    def imread(cls, path, idx) -> Image.Image:
        zf = cls._open(path)
        data = zf.read(cls.namelist(path)[idx])
        return Image.open(io.BytesIO(data)).convert("RGB")


def read_frames_from_dir(path, size=None):
    """Sorted frames from a directory of images; returns list[PIL RGB]."""
    frames = []
    for name in sorted(os.listdir(path)):
        img = Image.open(os.path.join(path, name)).convert("RGB")
        if size is not None:
            img = img.resize(size)
        frames.append(img)
    return frames


def read_frames_from_video(path, size=None):
    """Decode a video file: OpenCV's VideoCapture (BGR frames converted to
    RGB PIL images, reference test.py:74-94), else imageio."""
    frames = None
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, arr = cap.read()
            if not ok:
                break
            frames.append(Image.fromarray(cv2.cvtColor(arr,
                                                       cv2.COLOR_BGR2RGB)))
        cap.release()
        if not frames:
            frames = None  # cv2 present but couldn't decode -> try imageio
    except ImportError:  # pragma: no cover - environment-dependent
        pass
    if frames is None:
        try:
            import imageio
            reader = imageio.get_reader(path)
            frames = [Image.fromarray(arr[..., :3]) for arr in reader]
        except Exception as exc:  # pragma: no cover
            raise RuntimeError(
                f"No video-decode backend available for {path!r} (needs "
                "cv2, or imageio with ffmpeg/pyav). Extract the video to a "
                "frame directory and pass that instead.") from exc
    if size is not None:
        frames = [img.resize(size) for img in frames]
    return frames


def read_frames(path, size=None):
    if os.path.isdir(path):
        return read_frames_from_dir(path, size)
    return read_frames_from_video(path, size)


def read_masks_from_dir(path, size, dilate_iters=4):
    """Sorted per-frame masks, binarized + dilated; list of uint8 {0,1}."""
    return [binarize_and_dilate(Image.open(os.path.join(path, n)), size,
                                dilate_iters)
            for n in sorted(os.listdir(path))]


def load_manifest(data_root, dataset, split):
    """{video_name: frame_count} json manifest (reference datasets/*.json):
    from data_root first (the reference convention: the manifest next to
    the zips), else the manifests kept in the repository's datasets/."""
    path = os.path.join(data_root, dataset, f"{split}.json")
    if not os.path.exists(path):
        kept = os.path.join(os.path.dirname(__file__), "..", "..",
                            "datasets", dataset, f"{split}.json")
        if os.path.exists(kept):
            path = kept
    with open(path) as f:
        return json.load(f)


def frames_to_array(frames) -> np.ndarray:
    """list[PIL RGB] -> float32 (T, H, W, 3) in [-1, 1]."""
    arr = np.stack([np.asarray(f, np.uint8) for f in frames], 0)
    return arr.astype(np.float32) / 255.0 * 2.0 - 1.0


def masks_to_array(masks) -> np.ndarray:
    """list of uint8 {0,1} HxW -> float32 (T, H, W, 1)."""
    arr = np.stack([np.asarray(m, np.uint8) for m in masks], 0)
    return arr.astype(np.float32)[..., None]
