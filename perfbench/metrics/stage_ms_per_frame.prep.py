"""The prep span of SlidingWindowInpainter.__call__, nested in encode: the
host's preparation from the call's start until frames and masks are on
the device (the uint8 path, the mirror pad, the masks' cast and copies,
the two uploads), ms per frame over the traced videos (the program's
StageTimer); read for every serving cell (`.hq` and `.f32` are its names
in those cells)."""

from harness.readers import stage_ms_per_frame


def read(run):
    return stage_ms_per_frame(run, "prep")
