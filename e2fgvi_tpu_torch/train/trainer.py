"""Training runtime: data, models, optimizers, the step, checkpoints, logs.

Counterpart of e2fgvi_tpu/train/trainer.py:33-190 (reference
core/trainer.py, train.py):

    python -m e2fgvi_tpu_torch.train.trainer -c configs/train_e2fgvi.json \
        [--spynet_ckpt spynet.pth] [--max_steps N] [--device cpu]

- The reference JSON schema (configs/train_e2fgvi.json, _hq.json); its
  'seed' is honored: weights and sampling are seeded from it.
- Data parallel over processes (parallel/dist.py): each data rank
  decodes its share of the global batch (batch_size / data ranks) and
  DistributedDataParallel averages the gradients over the data ranks.
- Tensor parallel over `trainer.model_parallel` = m processes (1, 2 or 4;
  parallel/tensor.py): world = data x m, the m model ranks of a data index
  load the same batch, and each runs the transformer on its shard of the
  split GEMMs. Every rank builds the full seeded generator and keeps its
  shard, so step 0 is the m = 1 run's.
- Checkpoints every save_freq iterations under save_dir/<it>/ with a
  `latest` pointer (utils/checkpoints.py), full tensors whatever m; a new
  Trainer on the same save_dir resumes from the latest, at any m.
- TensorBoard scalars on rank 0, bucket-averaged over 100 iterations as the
  reference's add_summary (core/trainer.py:161-168).

Runs on the card unless the CPU is asked for by name.
"""

import json
import logging
import os
import time

import torch

from e2fgvi_tpu_torch.data.datasets import PrefetchLoader, TrainDataset
from e2fgvi_tpu_torch.models import discriminator, e2fgvi
from e2fgvi_tpu_torch.parallel import dist, tensor
from e2fgvi_tpu_torch.train import schedules
from e2fgvi_tpu_torch.train import step as step_lib
from e2fgvi_tpu_torch.utils import env
from e2fgvi_tpu_torch.utils.checkpoints import TrainCheckpointer
from e2fgvi_tpu_torch.utils.tb import SummaryWriter

log = logging.getLogger("e2fgvi_tpu_torch.train")


def build_models(config: dict, device):
    """The generator of config['model']['net'] and the discriminator,
    seeded from config['seed'], float32 on `device`."""
    seed = int(config.get("seed", 2021))
    gen = torch.Generator().manual_seed(seed)
    variant = "hq" if config["model"]["net"] == "e2fgvi_hq" else "base"
    g = e2fgvi.Generator(variant).init_weights(gen)
    d = discriminator.Discriminator().init_weights(gen)
    return g.to(device), d.to(device)


class Trainer:
    def __init__(self, config: dict, device=None, spynet_pretrained=None):
        self.config = config
        self.device = env.device(device)
        self.lt = config["train_data_loader"]["num_local_frames"]
        tr = config["trainer"]
        self.iterations = int(tr["iterations"])
        self.save_freq = int(tr.get("save_freq", 5000))
        self.log_freq = int(tr.get("log_freq", 100))
        self.no_dis = bool(config["model"].get("no_dis", 0))
        self.gan_type = config["losses"].get("GAN_LOSS", "hinge")
        self.seed = int(config.get("seed", 2021))
        model_parallel = tensor.check_model_parallel(
            tr.get("model_parallel", 1))

        self.n_proc, self.rank = dist.initialize(self.device)
        self.device = dist.local_device(self.device, self.rank)
        self.grid = tensor.make_grid(self.n_proc, self.rank, model_parallel)
        global_batch = int(tr["batch_size"])
        if global_batch % self.grid.data:
            raise ValueError(f"batch_size {global_batch} does not split "
                             f"over {self.grid.data} data-parallel ranks")
        self.local_batch = global_batch // self.grid.data
        self.dataset = TrainDataset(config["train_data_loader"],
                                    seed=self.seed)
        self.num_workers = int(tr.get("num_workers", 2))

        gen, dis = build_models(config, self.device)
        if spynet_pretrained is not None:
            gen.update_spynet.load_state_dict(spynet_pretrained, strict=True)
        tensor.shard_generator(gen, self.grid)
        self.lr_fn = schedules.make_schedule(dict(tr["scheduler"]),
                                             float(tr["lr"]))
        self.state = step_lib.TrainState(
            gen, dis, self.lr_fn, spynet_lr=float(tr.get("spynet_lr", 1.0)),
            beta1=float(tr.get("beta1", 0.0)),
            beta2=float(tr.get("beta2", 0.99)))
        self.ckpt = TrainCheckpointer(config["save_dir"], self.rank,
                                      self.grid)
        it = self.ckpt.restore(self.state)
        if it is not None:
            log.info("resumed from iteration %d", it)
        tensor.sync_replicated_grads(self.state.opt_g, gen, self.grid)
        tensor.sync_replicated_grads(self.state.opt_d, dis, self.grid)
        self.state.gen_call = dist.data_parallel(gen, self.device, self.grid)
        self.state.dis_call = dist.data_parallel(dis, self.device, self.grid)
        self._step = step_lib.make_train_step(
            self.lt, config["losses"], no_dis=self.no_dis,
            gan_type=self.gan_type)

        self.writer = None
        self._summary_acc = {}
        if self.rank == 0:
            self.writer = SummaryWriter(os.path.join(config["save_dir"],
                                                     "tb"))

    @property
    def iteration(self):
        return self.state.step

    def train(self, max_steps=None, on_step=None):
        """Run until `iterations` (or max_steps more). on_step(it, logs), if
        given, is called after every step."""
        target = self.iterations if max_steps is None else (
            self.iteration + max_steps)
        t0 = time.time()
        while self.iteration < target:
            loader = PrefetchLoader(
                self.dataset, batch_size=self.local_batch,
                num_workers=self.num_workers, shuffle=True, seed=self.seed,
                shard_index=self.grid.data_index,
                num_shards=self.grid.data)
            per_epoch = len(loader)
            if per_epoch == 0:
                raise ValueError(f"{len(self.dataset)} videos make no full "
                                 f"batch of {self.local_batch} a process")
            # epochs count from 1; a resumed run picks up where the
            # iteration count says its epoch stood
            loader.epoch = self.iteration // per_epoch + 1
            loader.start_batch = self.iteration % per_epoch
            for frames, masks, _ in loader:
                frames = torch.from_numpy(frames).to(self.device)
                masks = torch.from_numpy(masks).to(self.device)
                logs = self._step(self.state, frames, masks)
                it = self.iteration
                if on_step is not None:
                    on_step(it, logs)
                if self.writer is not None:
                    for k, v in logs.items():
                        self._summary_acc[k] = (self._summary_acc.get(k, 0.0)
                                                + float(v))
                    if it % 100 == 0:
                        for k, v in self._summary_acc.items():
                            self.writer.add_scalar(f"loss/{k}", v / 100, it)
                        self._summary_acc = {}
                if it % self.log_freq == 0:
                    rate = self.log_freq / max(time.time() - t0, 1e-9)
                    t0 = time.time()
                    log.info("[it %d] %s | lr %.2e | %.2f it/s", it,
                             " ".join(f"{k}={float(v):.4f}"
                                      for k, v in sorted(logs.items())),
                             self.lr_fn(it), rate)
                if it % self.save_freq == 0:
                    self.ckpt.save(self.state)
                if it >= target:
                    break
        return self.state

    def close(self):
        if self.writer is not None:
            self.writer.close()


def load_spynet(path):
    """A pretrained SPyNet .pth (the openmmlab release's keys,
    basic_module.{l}.basic_module.{m}.conv.*), or a wrapper of it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="E2FGVI training (PyTorch)")
    parser.add_argument("-c", "--config", required=True,
                        help="JSON config (reference schema)")
    parser.add_argument("--spynet_ckpt", default=None,
                        help="pretrained SPyNet .pth")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="default: the card; 'cpu' to train on the CPU")
    args = parser.parse_args(argv)

    env.setup()
    logging.basicConfig(level=logging.INFO)
    with open(args.config) as f:
        config = json.load(f)
    config["save_dir"] = os.path.join(
        config.get("save_dir", "release_model/"),
        "{}_{}".format(config["model"]["net"],
                       os.path.basename(args.config).split(".")[0]))
    pretrained = load_spynet(args.spynet_ckpt) if args.spynet_ckpt else None
    trainer = Trainer(config, device=args.device,
                      spynet_pretrained=pretrained)
    try:
        trainer.train(max_steps=args.max_steps)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
