"""Mask preprocessing on the host: nearest-resize, binarize, dilate.

The port's own copy of the JAX package's mask preprocessing
(e2fgvi_tpu/data/masks.py:122-152), the same function in numpy: the
reference resizes masks nearest, binarizes them at > 0 and dilates them 4
times with a 3x3 cross (test.py:57-70, core/dataset.py:120-128). The JAX
package's optional C++ dilation is not carried over. Outputs are uint8
{0, 1} masks (1 = hole).
"""

import numpy as np
from PIL import Image


def dilate_cross(mask: np.ndarray, iterations: int = 4) -> np.ndarray:
    """Binary dilation with the 3x3 cross structuring element.

    Matches cv2.dilate(m, cv2.getStructuringElement(MORPH_CROSS,(3,3)),
    iterations=N) on {0,1} masks (reference core/dataset.py:124-128)."""
    m = mask.astype(bool)
    for _ in range(iterations):
        up = np.zeros_like(m)
        up[:-1] = m[1:]
        down = np.zeros_like(m)
        down[1:] = m[:-1]
        left = np.zeros_like(m)
        left[:, :-1] = m[:, 1:]
        right = np.zeros_like(m)
        right[:, 1:] = m[:, :-1]
        m = m | up | down | left | right
    return m.astype(np.uint8)


def binarize_and_dilate(mask_img: Image.Image, size=None,
                        iterations: int = 4) -> np.ndarray:
    """Reference mask preprocessing: nearest-resize, >0 binarize, dilate
    (test.py:57-70 / core/dataset.py:120-128). Returns uint8 {0,1} HxW."""
    if size is not None:
        mask_img = mask_img.resize(size, Image.NEAREST)
    m = (np.array(mask_img.convert("L")) > 0).astype(np.uint8)
    return dilate_cross(m, iterations)
