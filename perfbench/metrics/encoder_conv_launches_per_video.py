"""Launches of C, the port's float32 convolution kernel, by the E2FGVI
encoder's stride-1 convolutions (one a dense layer, one a group of a
grouped one: 18 an encoder call), per traced video: whether the f32
encoder runs through the hand-written kernel (40.5 on the DAVIS pool at 35
frames an encoder call) and the bfloat16 paths bypass it (0).
`encoder_conv_launches` is a count that the program's StageTimer returns
beside its spans (in `stages_ms`, under a name of its own); a program
without it reads None. Read in the f32 cell (`.f32`)."""


def read(run):
    stages = run.get("stages_ms") or {}
    if "encoder_conv_launches" not in stages or not run.get("latencies"):
        return None
    return stages["encoder_conv_launches"] / len(run["latencies"])
