"""Share of its roofline of K3, focal window attention: the work these
videos need (harness/work.py) at the peak, over its device time; read
for every serving cell (`.hq` and `.f32` are its names in those cells)."""

from harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k3")
