"""The port's data-parallel training (e2fgvi_tpu_torch/parallel/dist.py)
in two processes on the CPU: the world from the E2FGVI_* variables, gloo,
DistributedDataParallel around the generator and the discriminator. One
GAN step over 2 processes, each with half of the global batch, equals the
same step in one process on the whole batch: the losses averaged over the
ranks within rtol 2e-4, and every discriminator and generator gradient
that the optimizers' steps read (after the all-reduce) within GRAD_REL of
its single-process norm plus GRAD_FLOOR per element. The bound is that of
splitting the batch, not of the all-reduce (which adds the ranks' halves
exactly): a batch of 1 takes other float32 CPU kernels than a batch of 2,
and a sample position that moves across a pixel changes the bilinear
gradient, so the generator's gradients of the two halves summed in one
process, with no DistributedDataParallel, already differ from the batch of
2 by up to 5.4e-4 in relative norm (median 3e-4; the discriminator's
4e-6); the floor is for the pool layers' gradients, which cancel to
~1e-6. A rank whose gradients were not averaged is off by its half of the
batch, about 1 in relative norm. The reference's DDP contract, as
tests/test_distributed.py holds the JAX package to it."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
GRAD_REL, GRAD_FLOOR = 2e-3, 1e-9


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(nprocs, outdir):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("E2FGVI_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "MASTER_"))}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(nprocs), str(port),
         str(outdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(nprocs)]
    try:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return torch.load(os.path.join(outdir, f"step_{nprocs}proc.pt"),
                      weights_only=True)


def test_two_process_step_matches_single_process(tmp_path):
    two = _run(2, tmp_path)
    one = _run(1, tmp_path)
    assert set(two["losses"]) == set(one["losses"])
    assert "dis_loss" in one["losses"]
    for k, v in one["losses"].items():
        np.testing.assert_allclose(two["losses"][k], v, rtol=2e-4, err_msg=k)
    over, worst = {}, 0.0
    for m in ("dis", "gen"):
        assert set(two[m]) == set(one[m]) and one[m], m
        for k, want in one[m].items():
            want = want.double()
            err = float((two[m][k].double() - want).norm())
            bound = (GRAD_REL * float(want.norm())
                     + GRAD_FLOOR * want.numel() ** 0.5)
            worst = max(worst, err / bound)
            if not err <= bound:
                over[f"{m}.{k}"] = (err, bound)
    print(f"worst gradient error over its bound: {worst:.3g}")
    assert not over, over
