"""DiT forwards per traced video (two a denoising step: the prompt's and
the negative prompt's). `dit_forwards` is a count that the program's
StageTimer returns beside its spans (in `stages_ms`, under a name of its
own); a program without it reads None. Read in the vace cell (`.vace` is
its name there)."""


def read(run):
    stages = run.get("stages_ms") or {}
    if "dit_forwards" not in stages or not run.get("latencies"):
        return None
    return stages["dit_forwards"] / len(run["latencies"])
