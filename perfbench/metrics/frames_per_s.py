"""All frames of all videos completed in the window over the window's time
(host clock); read for every serving cell (`.hq` and `.f32` are its
names in those cells)."""

from harness.readers import frames_per_s


def read(run):
    return frames_per_s(run)
