"""Learning-rate schedules, stepped per iteration.

Counterpart of e2fgvi_tpu/train/schedules.py (reference
core/lr_scheduler.py): plain Python functions of the iteration, built from
the reference JSON scheduler block (configs/train_e2fgvi.json
'trainer.scheduler').
"""

import math


def multistep_restart_lr(base_lr, milestones, gamma=0.1, restarts=(0,),
                         restart_weights=(1.0,)):
    """lr(step) of MultiStepRestartLR (lr_scheduler.py:9-47)."""
    milestones = sorted(int(m) for m in milestones)
    restarts = tuple(int(r) for r in restarts)

    def lr(step):
        w = 1.0
        for r, rw in zip(restarts, restart_weights):
            if step >= r:
                w = rw
        cur = base_lr * w
        for m in milestones:
            if step >= m:
                cur *= gamma
        return cur

    return lr


def cosine_annealing_restart_lr(base_lr, periods, restart_weights=(1.0,),
                                eta_min=1e-7):
    """lr(step) of CosineAnnealingRestartLR (lr_scheduler.py:68-112)."""
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]
    starts = [0] + cumulative[:-1]

    def lr(step):
        idx = min(sum(step > c for c in cumulative), len(periods) - 1)
        w = restart_weights[idx]
        return (eta_min + w * 0.5 * (base_lr - eta_min)
                * (1 + math.cos(math.pi * (step - starts[idx])
                                / periods[idx])))

    return lr


def make_schedule(config_sched: dict, base_lr: float):
    """lr(step) from a reference-style scheduler block."""
    kind = config_sched["type"]
    if kind in ("MultiStepLR", "MultiStepRestartLR"):
        return multistep_restart_lr(base_lr, config_sched["milestones"],
                                    config_sched.get("gamma", 0.1))
    if kind == "CosineAnnealingRestartLR":
        return cosine_annealing_restart_lr(
            base_lr, config_sched["periods"],
            tuple(config_sched.get("restart_weights", (1.0,))))
    raise NotImplementedError(f"Scheduler {kind} is not implemented")
