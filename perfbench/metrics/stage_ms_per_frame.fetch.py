"""The fetch span of SlidingWindowInpainter.__call__, after blend: the
composite's copy to the host, its numpy conversion and the list of
frames, ms per frame over the traced videos (the program's StageTimer);
read for every serving cell (`.hq` and `.f32` are its names in those
cells)."""

from harness.readers import stage_ms_per_frame


def read(run):
    return stage_ms_per_frame(run, "fetch")
