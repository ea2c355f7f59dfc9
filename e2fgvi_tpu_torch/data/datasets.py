"""The evaluation dataset over zipped-JPEG video archives.

The port's own copy of the JAX package's TestDataset (e2fgvi_tpu/data/
datasets.py; reference core/dataset.py): all frames of a video, resized,
and its fixed mask PNGs, binarized and dilated 4 times. The training
dataset and its loader wait for the port's training slice.
"""

import os

import numpy as np
from PIL import Image

from e2fgvi_tpu_torch.data import readers
from e2fgvi_tpu_torch.data.masks import binarize_and_dilate


class TestDataset:
    def __init__(self, data_root, dataset, size=(432, 240)):
        self.data_root = data_root
        self.dataset = dataset
        self.size = size
        self.video_dict = readers.load_manifest(data_root, dataset, "test")
        self.video_names = list(self.video_dict.keys())

    def __len__(self):
        return len(self.video_names)

    def __getitem__(self, index):
        """(frames (T, H, W, 3) float32 in [-1, 1], masks (T, H, W, 1)
        float32 {0, 1}, name, frames (T, H, W, 3) uint8)."""
        name = self.video_names[index]
        length = self.video_dict[name]
        zip_path = os.path.join(self.data_root, self.dataset, "JPEGImages",
                                f"{name}.zip")
        frames, masks = [], []
        for i in range(length):
            frames.append(
                readers.ZipFrameReader.imread(zip_path, i).resize(self.size))
            mask_path = os.path.join(self.data_root, self.dataset,
                                     "test_masks", name,
                                     str(i).zfill(5) + ".png")
            masks.append(binarize_and_dilate(Image.open(mask_path),
                                             self.size))
        orig = np.stack([np.asarray(f, np.uint8) for f in frames])
        return (readers.frames_to_array(frames),
                readers.masks_to_array(masks), name, orig)
