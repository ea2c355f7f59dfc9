"""Launches of C1, the port's float32 3x3 convolution kernel (feat_prop's
offset head and backbone), per traced video: whether the f32 serving path
runs its propagation convolutions through the hand-written kernel (124 a
window batch of 11 frames) and the bfloat16 paths bypass it (0).
`conv_launches` is a count that the program's StageTimer returns beside
its spans (in `stages_ms`, under a name of its own); a program without it
reads None. Read for every serving cell (`.hq` and `.f32` are its names
in those cells)."""


def read(run):
    stages = run.get("stages_ms") or {}
    if "conv_launches" not in stages or not run.get("latencies"):
        return None
    return stages["conv_launches"] / len(run["latencies"])
