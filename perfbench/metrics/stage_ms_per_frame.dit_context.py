"""VACE's context blocks inside the sampling loop (span `dit_context`,
nested in `dit`, around each forward's context patch embedding, 15
blocks and hint projections), ms per frame over the traced videos (the
program's StageTimer); read in the vace cell (`.vace` is its name
there)."""

from harness.readers import stage_ms_per_frame


def read(run):
    return stage_ms_per_frame(run, "dit_context")
