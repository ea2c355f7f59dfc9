"""The VAE encode stage of a Wan-VACE call of SlidingWindowInpainter.
__call__ (VACE's context: the inactive and the reactive frames encoded,
the mask folded), ms per frame over the traced videos (the program's
StageTimer); read in the vace cell (`.vace` is its name there)."""

from harness.readers import stage_ms_per_frame


def read(run):
    return stage_ms_per_frame(run, "vae_encode")
