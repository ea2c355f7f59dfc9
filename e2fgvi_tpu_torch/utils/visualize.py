"""Flow-field visualization (Middlebury color wheel) for debugging.

The port's own copy of e2fgvi_tpu/utils/visualize.py: standard
optical-flow rendering (Baker et al., ICCV 2007 color-wheel scheme) of
channel-last (H, W, 2) (dx, dy) flows, numpy only.
"""

import numpy as np


def _colorwheel():
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    for count, (a, b, rising) in (
            (ry, (0, 1, True)), (yg, (0, 1, False)), (gc, (1, 2, True)),
            (cb, (1, 2, False)), (bm, (2, 0, True)), (mr, (2, 0, False))):
        ramp = np.floor(255 * np.arange(count) / count)
        if rising:
            wheel[col: col + count, a] = 255
            wheel[col: col + count, b] = ramp
        else:
            wheel[col: col + count, a] = 255 - ramp
            wheel[col: col + count, b] = 255
        col += count
    return wheel


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None
                  ) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 visualization."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u * u + v * v)

    wheel = _colorwheel()
    ncols = wheel.shape[0]
    angle = np.arctan2(-v, -u) / np.pi
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        inside = rad <= 1
        col = np.where(inside, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col)
    return img
