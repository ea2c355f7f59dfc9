"""Training checkpoints: torch.save per iteration plus a `latest` pointer.

Counterpart of e2fgvi_tpu/utils/checkpoints.py:30-61 (reference
core/trainer.py:170-262, three .pth files and a latest.ckpt pointer): under
save_dir/<it>/ the generator (gen.pth, the reference checkpoint's keys, so
the inference CLIs load it), the discriminator with its spectral-norm
vectors (dis.pth), and opt.pth with both optimizers, the frozen SPyNet of
the flow loss and the iteration; `latest` names the newest. Only rank 0
writes.
"""

import os

import torch


class TrainCheckpointer:
    """Iteration-addressed training checkpoints with resume discovery."""

    def __init__(self, save_dir, rank=0):
        self.save_dir = os.path.abspath(save_dir)
        self.rank = rank
        os.makedirs(self.save_dir, exist_ok=True)

    def it_dir(self, it):
        return os.path.join(self.save_dir, str(it))

    def save(self, state):
        """Write a train step's TrainState at its iteration."""
        if self.rank != 0:
            return
        d = self.it_dir(state.step)
        os.makedirs(d, exist_ok=True)
        torch.save(state.gen.state_dict(), os.path.join(d, "gen.pth"))
        torch.save(state.dis.state_dict(), os.path.join(d, "dis.pth"))
        torch.save({"opt_g": state.opt_g.state_dict(),
                    "opt_d": state.opt_d.state_dict(),
                    "fixed_spynet": state.fixed_spynet.state_dict(),
                    "iteration": state.step}, os.path.join(d, "opt.pth"))
        with open(os.path.join(self.save_dir, "latest"), "w") as f:
            f.write(str(state.step))

    def latest_iteration(self):
        latest = os.path.join(self.save_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as f:
                return int(f.read().strip().splitlines()[-1])
        its = [int(d) for d in os.listdir(self.save_dir) if d.isdigit()]
        return max(its) if its else None

    def restore(self, state, it=None):
        """Load iteration `it` (default the latest) into `state` in place;
        returns the iteration, or None where there is no checkpoint."""
        if it is None:
            it = self.latest_iteration()
        if it is None:
            return None
        d = self.it_dir(it)
        dev = next(state.gen.parameters()).device

        def load(name):
            return torch.load(os.path.join(d, name), map_location=dev,
                              weights_only=True)
        state.gen.load_state_dict(load("gen.pth"), strict=True)
        state.dis.load_state_dict(load("dis.pth"), strict=True)
        opt = load("opt.pth")
        state.opt_g.load_state_dict(opt["opt_g"])
        state.opt_d.load_state_dict(opt["opt_d"])
        state.fixed_spynet.load_state_dict(opt["fixed_spynet"], strict=True)
        state.step = int(opt["iteration"])
        return it
