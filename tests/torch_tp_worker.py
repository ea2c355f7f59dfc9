"""Worker for tests/test_torch_tensor_parallel.py, run as a subprocess:

    python tests/torch_tp_worker.py <mode> <rank> <world> <model> <port> <dir>

Each mode runs the port's tensor parallelism (e2fgvi_tpu_torch/parallel/
tensor.py) on the CPU: the world from the E2FGVI_* variables
(parallel/dist.detect_world), the processes meet over gloo, and rank r sits
at data index r // model, model index r % model. world = model = 1 runs the
same work in one process.

- block: <dir>/block.npz holds one transformer block's reference-layout
  weights (full), its input x and output_size; every rank builds the
  block, keeps its shard (tensor.shard_generator on a one-block stack) and
  writes its output to <dir>/block_<form>_<rank>.npy, F3N in the form
  <dir>/form names (conv or literal).
- step: one GAN step (train/step.py, remat on) of the HQ generator seeded
  as the Trainer seeds it, on a global batch of 2 split over the data
  ranks; rank r writes <dir>/step_<rank>.pt: the losses, every
  discriminator and generator gradient as its optimizer step reads it
  (the rank's shard of split parameters; the replicated ones averaged over
  the model ranks, as the Trainer does), and the tensor-parallel
  all-reduces in the order the rank ran them (tensor.TRACE).
- trainer: the Trainer on <dir>/config.json at model_parallel <model>,
  one step; rank r writes <dir>/trainer_<rank>.pt: the step's losses,
  whether the state restored at the start (if any) equals the checkpoint
  it came from bit for bit once gathered, and the iteration.
"""

import json
import os
import sys


def _restored_equal(tr, tensor):
    """The Trainer's restored generator and its Adam state, gathered over
    the model ranks, against the checkpoint files, bit for bit."""
    import torch
    it = tr.ckpt.latest_iteration()
    d = tr.ckpt.it_dir(it)
    gen = tensor.gather_over_model(tr.state.gen.state_dict(), tr.grid)
    opt = tensor.gather_optimizer_state(
        tr.state.opt_g.state_dict(),
        tensor.optimizer_param_names(tr.state.opt_g, tr.state.gen), tr.grid)
    want_gen = torch.load(os.path.join(d, "gen.pth"), weights_only=True)
    want_opt = torch.load(os.path.join(d, "opt.pth"),
                          weights_only=True)["opt_g"]
    same = set(gen) == set(want_gen) and all(
        torch.equal(gen[k], want_gen[k]) for k in gen)
    for i, s in want_opt["state"].items():
        for k, v in s.items():
            same = same and torch.equal(opt["state"][i][k], v)
    return bool(same)


def main():
    mode, rank, world, model, port, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        sys.argv[5], sys.argv[6])
    if world > 1:
        os.environ["E2FGVI_NUM_PROCESSES"] = str(world)
        os.environ["E2FGVI_PROCESS_ID"] = str(rank)
        os.environ["E2FGVI_COORDINATOR"] = f"127.0.0.1:{port}"
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))

    import numpy as np
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(2 if world <= 2 else 1)
    from e2fgvi_tpu_torch.parallel import dist, tensor

    dev = torch.device("cpu")
    if mode == "trainer":
        from e2fgvi_tpu_torch.train.trainer import Trainer
        with open(os.path.join(out, "config.json")) as f:
            config = json.load(f)
        config["trainer"]["model_parallel"] = model
        restoring = os.path.isfile(os.path.join(config["save_dir"],
                                                "latest"))
        tr = Trainer(config, device="cpu")
        res = {"restored_equal": (_restored_equal(tr, tensor)
                                  if restoring else None)}
        logs = {}
        tr.train(max_steps=1, on_step=lambda it, lg: logs.update(
            {it: {k: float(v) for k, v in lg.items()}}))
        tr.close()
        res.update(losses=logs, iteration=tr.iteration)
        torch.save(res, os.path.join(out, f"trainer_{rank}.pt"))
        if world > 1:
            tdist.destroy_process_group()
        print(f"[worker {rank}/{world}] done: {res}", flush=True)
        return

    size, r = dist.initialize(dev)
    assert (size, r) == (world, rank), (size, r)
    grid = tensor.make_grid(world, rank, model)

    if mode == "block":
        from e2fgvi_tpu_torch.models import tfocal
        with open(os.path.join(out, "form")) as f:
            form = f.read().strip()
        if form == "literal":
            tfocal._fusion_feed_forward_conv = \
                tfocal._fusion_feed_forward_literal
        data = np.load(os.path.join(out, "block.npz"))
        block = tfocal.TemporalFocalTransformerBlock()
        block.load_state_dict({k[3:]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("sd.")},
                              strict=True)
        stack = torch.nn.Module()
        stack.transformer = torch.nn.ModuleList([block])
        tensor.shard_generator(stack, grid)
        with torch.no_grad():
            y = tfocal.transformer_block(
                block, torch.from_numpy(data["x"]),
                tuple(int(v) for v in data["output_size"]))
        np.save(os.path.join(out, f"block_{form}_{rank}.npy"), y.numpy())
    elif mode == "step":
        from e2fgvi_tpu_torch.train import step as step_lib
        from e2fgvi_tpu_torch.train.trainer import build_models
        config = {"seed": 3, "model": {"net": "e2fgvi_hq"}}
        gen, dis = build_models(config, dev)
        tensor.shard_generator(gen, grid)
        state = step_lib.TrainState(gen, dis, lambda s: 1e-4, spynet_lr=0.5)
        tensor.sync_replicated_grads(state.opt_g, gen, grid)
        tensor.sync_replicated_grads(state.opt_d, dis, grid)
        state.gen_call = dist.data_parallel(gen, dev, grid)
        state.dis_call = dist.data_parallel(dis, dev, grid)
        losses = {"hole_weight": 1, "valid_weight": 1, "flow_weight": 1,
                  "adversarial_weight": 0.01}
        step = step_lib.make_train_step(3, losses)
        grads = {}

        def keep_grads(name, module):
            def hook(opt, args, kwargs):
                grads[name] = {k: p.grad.detach().clone()
                               for k, p in module.named_parameters()}
            return hook

        state.opt_d.register_step_pre_hook(keep_grads("dis", dis))
        state.opt_g.register_step_pre_hook(keep_grads("gen", gen))
        # the batch of tests/torch_dist_worker.py: masks covering the same
        # share of each clip, so each data rank's normalization is global
        rng = np.random.default_rng(0)
        gb = 2
        frames = rng.uniform(-1, 1, (gb, 4, 120, 216, 3)).astype(np.float32)
        mask = (rng.uniform(0, 1, (1, 4, 120, 216, 1)) > 0.7).astype(
            np.float32)
        masks = np.concatenate([mask, np.roll(mask, 37, axis=3)])
        per = gb // grid.data
        lo = grid.data_index * per
        tensor.TRACE = []
        logs = step(state, torch.from_numpy(frames[lo: lo + per]),
                    torch.from_numpy(masks[lo: lo + per]))
        trace, tensor.TRACE = tensor.TRACE, None
        vals = torch.stack([logs[k] for k in sorted(logs)])
        if grid.data > 1:       # the data ranks' mean, as DDP's losses
            tdist.all_reduce(vals)
            vals /= world
        torch.save({"losses": dict(zip(sorted(logs), vals.tolist())),
                    "trace": trace, **grads},
                   os.path.join(out, f"step_{rank}.pt"))
    else:
        raise SystemExit(f"unknown mode {mode}")
    if world > 1:
        tdist.destroy_process_group()
    print(f"[worker {rank}/{world}] {mode} done", flush=True)


if __name__ == "__main__":
    main()
