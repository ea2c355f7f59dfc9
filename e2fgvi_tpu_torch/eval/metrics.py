"""Frame quality metrics on the host: PSNR, SSIM and the flows' end-point
error.

The port's own copy of the JAX package's (e2fgvi_tpu/eval/metrics.py),
with the reference core/metrics.py semantics:

- PSNR on [0, 255] float64 (metrics.py:20-36).
- SSIM matching scikit-image 0.16 `measure.compare_ssim` with
  data_range=255, multichannel=True, win_size=65 (metrics.py:39-54):
  uniform filter, sample covariance, per-channel average, border-cropped
  mean. The border crop keeps only fully-interior windows, so the uniform
  filter reduces to 'valid' box means (scipy.ndimage.uniform_filter
  cropped to the interior) over all 5 statistics and all channels in one
  pass.

- End-point error (calculate_epe, metrics.py:12-17): the mean Euclidean
  distance between two (..., 2) flows.

The Frechet distance for VFID is eval/vfid.py.
"""

import numpy as np


def calculate_epe(flow1, flow2):
    """End-point error between two (..., 2) flow arrays."""
    return float(np.sqrt(((np.asarray(flow1) - np.asarray(flow2)) ** 2
                          ).sum(-1)).mean())


def calculate_psnr(img1, img2):
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _box_mean_valid(a, win):
    """Box means over all fully-inside window positions.

    a: (..., H, W) float64. Returns (..., H-win+1, W-win+1): the
    uniform-filter box mean restricted to interior windows, which never
    touch the boundary, so the filter's edge mode is irrelevant."""
    from scipy.ndimage import uniform_filter
    pad = (win - 1) // 2
    f = uniform_filter(a, size=[1] * (a.ndim - 2) + [win, win])
    return f[..., pad:-pad, pad:-pad]


def _ssim_interior(x, y, win_size, data_range, k1=0.01, k2=0.03):
    """SSIM map over interior windows; x, y: (..., H, W) float64.

    Returns the mean over the window positions, per leading index."""
    npix = win_size ** 2
    cov_norm = npix / (npix - 1)          # sample covariance
    stats = np.stack([x, y, x * x, y * y, x * y])
    ux, uy, uxx, uyy, uxy = _box_mean_valid(stats, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean(axis=(-2, -1))


def calculate_ssim(img1, img2, data_range=255, win_size=65,
                   multichannel=True):
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if multichannel and img1.ndim == 3:
        # (C, H, W): all channels (and all 5 stats) in one vectorized pass
        x = np.ascontiguousarray(np.moveaxis(img1, -1, 0))
        y = np.ascontiguousarray(np.moveaxis(img2, -1, 0))
        return float(_ssim_interior(x, y, win_size, data_range).mean())
    return float(_ssim_interior(img1, img2, win_size, data_range))


def calc_psnr_and_ssim(img1, img2):
    """Per-frame PSNR + SSIM on [0, 255] images (metrics.py:39-54)."""
    return calculate_psnr(img1, img2), calculate_ssim(img1, img2)
