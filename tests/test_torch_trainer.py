"""The port's Trainer (e2fgvi_tpu_torch/train/trainer.py) end to end on the
CPU: synthetic YouTube-VOS-layout zips built as tests/test_trainer.py
builds them, the HQ model at 216x120, 3 local + 1 reference frames, batch
1. Two steps, a checkpoint at each, and a resume in a fresh Trainer: its
third step equals the third step of a run that was never interrupted
(losses and every parameter, exactly: the CPU path is deterministic, and
the resumed run restores weights, spectral-norm vectors, both Adam states,
the frozen SPyNet and its place in the data order)."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from e2fgvi_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mini_train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    name = "mini-vos"
    img_dir = root / name / "JPEGImages"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    manifest = {}
    for v in range(2):
        frames = 10
        with zipfile.ZipFile(img_dir / f"video{v}.zip", "w") as zf:
            for i in range(frames):
                img = Image.fromarray(
                    rng.integers(0, 255, (120, 216, 3), dtype=np.uint8))
                p = root / "tmp.jpg"
                img.save(p, quality=85)
                zf.write(p, arcname=f"{i:05d}.jpg")
        manifest[f"video{v}"] = frames
    with open(root / name / "train.json", "w") as f:
        json.dump(manifest, f)
    return str(root), name


def _config(root, name, save_dir):
    return {
        "seed": 7,
        "save_dir": str(save_dir),
        "train_data_loader": {
            "name": name, "data_root": root, "w": 216, "h": 120,
            "num_local_frames": 3, "num_ref_frames": 1,
        },
        "losses": {"hole_weight": 1, "valid_weight": 1, "flow_weight": 1,
                   "adversarial_weight": 0.01, "GAN_LOSS": "hinge"},
        "model": {"net": "e2fgvi_hq", "no_dis": 0},
        "trainer": {
            "beta1": 0, "beta2": 0.99, "lr": 1e-4, "batch_size": 1,
            "num_workers": 1, "log_freq": 1, "save_freq": 1,
            "iterations": 1000,
            "scheduler": {"type": "MultiStepLR", "milestones": [400],
                          "gamma": 0.1},
        },
    }


def _train(config, steps):
    tr = Trainer(config, device="cpu")
    seen = {}
    tr.train(max_steps=steps,
             on_step=lambda it, logs: seen.update(
                 {it: {k: float(v) for k, v in logs.items()}}))
    tr.close()
    return tr, seen


def test_two_steps_and_a_resume_equal_an_uninterrupted_run(
        mini_train_root, tmp_path):
    root, name = mini_train_root
    whole, logs = _train(_config(root, name, tmp_path / "whole"), 3)
    assert whole.iteration == 3 and sorted(logs) == [1, 2, 3]
    assert all(np.isfinite(v) for step in logs.values()
               for v in step.values())

    cfg = _config(root, name, tmp_path / "parts")
    first, first_logs = _train(cfg, 2)
    assert first.iteration == 2 and first.ckpt.latest_iteration() == 2
    assert first_logs == {1: logs[1], 2: logs[2]}
    for it in ("1", "2"):
        assert sorted(os.listdir(os.path.join(cfg["save_dir"], it))) == [
            "dis.pth", "gen.pth", "opt.pth"]
    tb = os.listdir(os.path.join(cfg["save_dir"], "tb"))
    assert any(f.startswith("events.out.tfevents") for f in tb)

    resumed, resumed_logs = _train(cfg, 1)
    assert resumed.iteration == 3 and resumed_logs == {3: logs[3]}
    for a, b in ((resumed.state.gen, whole.state.gen),
                 (resumed.state.dis, whole.state.dis),
                 (resumed.state.fixed_spynet, whole.state.fixed_spynet)):
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            assert torch.equal(x, y), k
    # the frozen SPyNet never moved; the trainable one did
    sd0 = Trainer(_config(root, name, tmp_path / "fresh"),
                  device="cpu").state.gen.state_dict()
    for k, v in whole.state.fixed_spynet.state_dict().items():
        assert torch.equal(v, sd0["update_spynet." + k]), k
    assert not torch.equal(
        whole.state.gen.update_spynet.basic_module[0].basic_module[0]
        .conv.weight, sd0["update_spynet.basic_module.0.basic_module.0."
                          "conv.weight"])


def test_model_parallel_is_not_ported(mini_train_root, tmp_path):
    root, name = mini_train_root
    cfg = _config(root, name, tmp_path / "mp")
    cfg["trainer"]["model_parallel"] = 2
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        Trainer(cfg, device="cpu")
