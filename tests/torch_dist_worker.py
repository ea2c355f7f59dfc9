"""Worker for tests/test_torch_distributed.py, run as a subprocess:

    python tests/torch_dist_worker.py <rank> <nprocs> <port> <outdir>

One GAN train step of the port (e2fgvi_tpu_torch/train/step.py) on the
CPU: with nprocs > 1 the world comes from the E2FGVI_* variables
(parallel/dist.detect_world), the processes meet over gloo
(dist.initialize) and the generator and discriminator are wrapped in
DistributedDataParallel (dist.data_parallel); each rank takes its share of
the global batch. nprocs = 1 runs the same step on the whole batch. Rank 0
writes to <outdir>/step_<nprocs>proc.pt the losses averaged over ranks and
every discriminator and generator gradient as each optimizer step is about
to read it (after DistributedDataParallel's all-reduce).
"""

import os
import sys


def main():
    rank, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    if nprocs > 1:
        os.environ["E2FGVI_NUM_PROCESSES"] = str(nprocs)
        os.environ["E2FGVI_PROCESS_ID"] = str(rank)
        os.environ["E2FGVI_COORDINATOR"] = f"127.0.0.1:{port}"
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))

    import numpy as np
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(2)
    from e2fgvi_tpu_torch.parallel import dist
    from e2fgvi_tpu_torch.train import step as step_lib
    from e2fgvi_tpu_torch.train.trainer import build_models

    dev = torch.device("cpu")
    size, r = dist.initialize(dev)
    assert (size, r) == (nprocs, rank), (size, r)
    config = {"seed": 3, "model": {"net": "e2fgvi_hq"}}
    gen, dis = build_models(config, dev)
    state = step_lib.TrainState(gen, dis, lambda s: 1e-4, spynet_lr=0.5)
    state.gen_call = dist.data_parallel(gen, dev)
    state.dis_call = dist.data_parallel(dis, dev)
    assert (nprocs > 1) == (state.gen_call is not gen)
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

    # a global batch of 2 whose masks cover the same share of each clip
    # (one mask rolled): each rank's hole/valid normalization then equals
    # the global one, as the reference's per-rank DDP losses assume
    rng = np.random.default_rng(0)
    gb = 2
    frames = rng.uniform(-1, 1, (gb, 4, 120, 216, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, 4, 120, 216, 1)) > 0.7).astype(np.float32)
    masks = np.concatenate([mask, np.roll(mask, 37, axis=3)])
    per = gb // nprocs
    lo = rank * per
    logs = step(state, torch.from_numpy(frames[lo: lo + per]),
                torch.from_numpy(masks[lo: lo + per]))
    vals = torch.stack([logs[k] for k in sorted(logs)])
    if nprocs > 1:
        tdist.all_reduce(vals)
        vals /= nprocs
    out = {"losses": dict(zip(sorted(logs), vals.tolist())), **grads}
    if rank == 0:
        torch.save(out, os.path.join(outdir, f"step_{nprocs}proc.pt"))
    if nprocs > 1:
        tdist.destroy_process_group()
    print(f"[worker {rank}/{nprocs}] done: {out['losses']}", flush=True)


if __name__ == "__main__":
    main()
