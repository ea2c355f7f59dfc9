"""The sampling loop of a Wan-VACE call of SlidingWindowInpainter.__call__
(every step's two DiT forwards, their context blocks, guidance and the
Euler update), ms per frame over the traced videos (the program's
StageTimer); read in the vace cell (`.vace` is its name there)."""

from harness.readers import stage_ms_per_frame


def read(run):
    return stage_ms_per_frame(run, "dit")
