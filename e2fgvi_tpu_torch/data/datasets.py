"""Training and evaluation datasets over zipped-JPEG video archives.

The port's own copy of the JAX package's datasets (e2fgvi_tpu/data/
datasets.py:28-168; reference core/dataset.py):

- TrainDataset: per item, `num_local` consecutive + `num_ref` random
  frames of one video, a random moving mask, a random horizontal flip of
  the whole group; numpy (T, H, W, 3) in [-1, 1] and (T, H, W, 1) masks.
  Sampling is seeded per (seed, epoch, index), hash((seed, epoch, index)),
  as in the JAX package (the reference's config seed is never used).
- TestDataset: all frames of a video, resized, and its fixed mask PNGs,
  binarized and dilated 4 times.
- PrefetchLoader: a thread pool decoding batches ahead (PIL decode
  releases the GIL), padding the order to equal shard lengths as torch's
  DistributedSampler does.
"""

import os
import random

import numpy as np
from PIL import Image

from e2fgvi_tpu_torch.data import readers
from e2fgvi_tpu_torch.data.masks import (
    binarize_and_dilate, create_random_shape_with_random_motion)


class TrainDataset:
    def __init__(self, args: dict, seed: int = 2021):
        self.args = args
        self.num_local = args["num_local_frames"]
        self.num_ref = args["num_ref_frames"]
        self.size = (args["w"], args["h"])
        self.seed = seed
        self.video_dict = readers.load_manifest(args["data_root"],
                                                args["name"], "train")
        self.video_names = list(self.video_dict.keys())

    def __len__(self):
        return len(self.video_names)

    def _sample_index(self, length, rng):
        pivot = rng.randint(0, length - self.num_local)
        local = list(range(pivot, pivot + self.num_local))
        remain = sorted(set(range(length)) - set(local))
        refs = sorted(rng.sample(remain, self.num_ref))
        return local + refs

    def __getitem__(self, index, epoch: int = 0):
        rng = random.Random(hash((self.seed, epoch, index)))
        name = self.video_names[index % len(self.video_names)]
        length = self.video_dict[name]
        all_masks = create_random_shape_with_random_motion(
            length, image_height=self.size[1], image_width=self.size[0],
            seed=rng.random())
        idxs = self._sample_index(length, rng)
        zip_path = os.path.join(self.args["data_root"], self.args["name"],
                                "JPEGImages", f"{name}.zip")
        frames, masks = [], []
        flip = rng.random() < 0.5
        for i in idxs:
            img = readers.ZipFrameReader.imread(zip_path, i).resize(self.size)
            m = all_masks[i]
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                m = m.transpose(Image.FLIP_LEFT_RIGHT)
            frames.append(img)
            masks.append((np.asarray(m) > 0).astype(np.uint8))
        return (readers.frames_to_array(frames),
                readers.masks_to_array(masks), name)


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


class PrefetchLoader:
    """Thread-pool prefetching iterator over a dataset.

    Replaces torch DataLoader(num_workers=N): PIL decode releases the GIL,
    so threads overlap host decode with device compute. start_batch: the
    first batch of the epoch to yield (a resumed run's place in it)."""

    def __init__(self, dataset, batch_size=1, num_workers=2, shuffle=True,
                 seed=0, epoch=0, drop_last=True,
                 shard_index=0, num_shards=1, start_batch=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.start_batch = start_batch

    def __len__(self):
        """Batches an epoch yields, from start_batch 0."""
        n = len(self._order())
        return n // self.batch_size if self.drop_last else (
            -(-n // self.batch_size))

    def _order(self):
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(hash((self.seed, self.epoch))).shuffle(idxs)
        # pad to a multiple of num_shards by repeating indices (torch
        # DistributedSampler semantics): every shard gets the SAME length,
        # so every process runs the same number of jitted steps — unequal
        # shard lengths deadlock multi-host training at the stray batch
        if self.num_shards > 1 and len(idxs) % self.num_shards:
            pad = self.num_shards - len(idxs) % self.num_shards
            idxs = idxs + idxs[:pad]
        return idxs[self.shard_index::self.num_shards]

    def __iter__(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        order = self._order()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self.start_batch, len(self))]
        window = self.num_workers * 2
        with ThreadPoolExecutor(self.num_workers) as ex:
            pending = deque()
            it = iter(batches)
            for idxs in batches[:window]:
                pending.append(ex.submit(self._batch, idxs))
                next(it)
            while pending:
                yield pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(self._batch, nxt))

    def _batch(self, idxs):
        items = [self.dataset.__getitem__(i, epoch=self.epoch) for i in idxs]
        frames = np.stack([it[0] for it in items])
        masks = np.stack([it[1] for it in items])
        names = [it[2] for it in items]
        return frames, masks, names
