"""VFID: the Frechet distance between sets of I3D features.

The reference's calculate_vfid / calculate_frechet_distance
(core/metrics.py:86-151; e2fgvi_tpu/eval/metrics.py:95-120), including
its fallback: a matrix square root that is not finite is retaken with
eps on the covariances' diagonals, and an imaginary part above 1e-3 on
the diagonal raises. The JAX package's copy passes `disp=False` to
scipy.linalg.sqrtm, which SciPy 1.18 no longer accepts; this one calls
sqrtm with the matrix alone, which every SciPy version takes.
"""

import numpy as np
from scipy import linalg


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1 - mu2||^2 + tr(sigma1 + sigma2 - 2 sqrt(sigma1 sigma2))."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component "
                             f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_vfid(real_activations, fake_activations):
    """Two lists of 1-D feature vectors (one per video) -> VFID."""
    return frechet_distance(
        np.mean(real_activations, axis=0),
        np.cov(real_activations, rowvar=False),
        np.mean(fake_activations, axis=0),
        np.cov(fake_activations, rowvar=False))
