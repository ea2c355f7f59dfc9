"""Launches of C2, the port's kernel for RAFT's update-block convolutions
(ProPainter's flows: 10 an iteration of a field chunk, 2 for the mask head
a chunk), per traced video: whether RAFT's iterations run through the
hand-written kernel (202 a chunk of up to 16 fields at 20 iterations).
`raft_conv_launches` is a count that the program's StageTimer returns
beside its spans (in `stages_ms`, under a name of its own); a program
without it reads None. Read in the propainter cell (`.propainter`)."""


def read(run):
    stages = run.get("stages_ms") or {}
    if "raft_conv_launches" not in stages or not run.get("latencies"):
        return None
    return stages["raft_conv_launches"] / len(run["latencies"])
