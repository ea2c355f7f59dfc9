"""The allocator's peak over the window, GiB; read for every serving cell
(`.hq` and `.f32` are its names in those cells)."""

from harness.readers import peak_gib


def read(run):
    return peak_gib(run)
