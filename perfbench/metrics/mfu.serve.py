"""Model FLOPs of the traced videos over the traced window, as a share of
the dtype's peak; read for every serving cell (`.hq` and `.f32` are its
names in those cells)."""

from harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
