"""Share of the traced window with nothing on the device; read for every
serving cell (`.hq` and `.f32` are its names in those cells)."""

from harness.readers import idle_pct


def read(run):
    return idle_pct(run)
