"""ProPainter's image propagation stage of SlidingWindowInpainter.__call__
(nearest warps and the consistency check over every frame), ms per frame
over the traced videos (the program's StageTimer); read in the propainter
cell (`.propainter` is its name there)."""

from harness.readers import stage_ms_per_frame


def read(run):
    return stage_ms_per_frame(run, "img_prop")
