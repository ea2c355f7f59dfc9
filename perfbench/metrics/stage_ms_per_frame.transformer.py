"""The transformer (soft split, K3, F3N, soft comp) stage of
SlidingWindowInpainter.__call__, ms per frame over the traced videos
(the program's StageTimer); read for every serving cell (`.hq` and
`.f32` are its names in those cells)."""

from harness.readers import stage_ms_per_frame


def read(run):
    return stage_ms_per_frame(run, "transformer")
