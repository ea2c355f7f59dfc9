"""Masks on the host: training-mask synthesis and mask preprocessing.

The port's own copy of the JAX package's mask code (e2fgvi_tpu/data/
masks.py), in numpy and PIL:

- training masks (masks.py:22-120; reference core/utils.py:186-315): a
  random closed cubic-Bezier blob rasterized with PIL, moving by an
  accelerated random walk in half of the videos and static in the other
  half; the same draws from the same seed as the JAX package's;
- preprocessing (masks.py:122-152): the reference resizes masks nearest,
  binarizes them at > 0 and dilates them 4 times with a 3x3 cross
  (test.py:57-70, core/dataset.py:120-128). The JAX package's optional C++
  dilation is not carried over.

Outputs are uint8 masks (1 or 255 = hole).
"""

import random

import numpy as np
from PIL import Image, ImageDraw


def _bezier_points(p0, p1, p2, p3, n=24):
    t = np.linspace(0.0, 1.0, n)[:, None]
    return ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * p1 +
            3 * (1 - t) * t ** 2 * p2 + t ** 3 * p3)


def random_shape(edge_num=9, ratio=0.7, width=432, height=240,
                 rng: random.Random | None = None):
    """Random closed Bezier blob as a uint8 {0,255} image of (height,width).

    Control-point construction mirrors the reference get_random_shape
    (utils.py:227-265): points_num = 3*edges+1 on a perturbed unit circle.
    """
    rng = rng or random
    points_num = edge_num * 3 + 1
    angles = np.linspace(0, 2 * np.pi, points_num)
    radii = 2 * ratio * np.array([rng.random() for _ in range(points_num)]) \
        + 1 - ratio
    verts = np.stack((np.cos(angles), np.sin(angles)), 1) * radii[:, None]
    verts[-1] = verts[0]

    # dense polyline through the piecewise cubic curve
    pts = []
    for i in range(edge_num):
        seg = verts[3 * i: 3 * i + 4]
        pts.append(_bezier_points(seg[0], seg[1], seg[2], seg[3]))
    poly = np.concatenate(pts, 0)

    lo = poly.min(0)
    hi = poly.max(0)
    span = np.maximum(hi - lo, 1e-6)
    # rasterize at a working resolution, then resize to target
    rw, rh = 256, 256
    xy = (poly - lo) / span * [rw - 1, rh - 1]
    img = Image.new("L", (rw, rh), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in xy], fill=255)
    img = img.resize((width, height), Image.BILINEAR)
    arr = (np.array(img) > 127).astype(np.uint8) * 255
    ys, xs = np.nonzero(arr)
    if len(ys) == 0:
        arr[height // 2, width // 2] = 255
        ys, xs = np.nonzero(arr)
    return Image.fromarray(arr[ys.min(): ys.max() + 1,
                               xs.min(): xs.max() + 1])


def _random_velocity(max_speed=3, dist="uniform", rng=None):
    rng = rng or random
    if dist == "uniform":
        speed = rng.uniform(0, max_speed)
    else:
        speed = abs(rng.gauss(0, max_speed / 2))
    return (speed, rng.uniform(0, 2 * np.pi))


def _accelerate(velocity, max_acc, rng):
    speed, angle = velocity
    d_speed, d_angle = max_acc
    return (speed + rng.gauss(0, d_speed / 2),
            angle + rng.gauss(0, d_angle / 2))


def create_random_shape_with_random_motion(video_length, image_height=240,
                                           image_width=432, seed=None):
    """List of `video_length` PIL 'L' masks ({0,255}); 50% static, 50%
    moving with an accelerated random walk (reference utils.py:186-224)."""
    rng = random.Random(seed) if seed is not None else random
    height = rng.randint(image_height // 3, image_height - 1)
    width = rng.randint(image_width // 3, image_width - 1)
    edge_num = rng.randint(6, 8)
    ratio = rng.randint(6, 8) / 10
    region = random_shape(edge_num, ratio, width=width, height=height,
                          rng=rng)
    rw, rh = region.size
    x = rng.randint(0, image_height - rh)
    y = rng.randint(0, image_width - rw)
    velocity = _random_velocity(3, "uniform", rng)

    def render(px, py):
        m = Image.new("L", (image_width, image_height), 0)
        m.paste(region, (py, px))
        return m

    masks = [render(x, y)]
    if rng.uniform(0, 1) > 0.5:
        return masks * video_length
    for _ in range(video_length - 1):
        speed, angle = velocity
        x = int(x + speed * np.cos(angle))
        y = int(y + speed * np.sin(angle))
        velocity = _accelerate(velocity, (3, 0.5), rng)
        if (x > image_height - rh or x < 0 or
                y > image_width - rw or y < 0):
            velocity = _random_velocity(3, "guassian", rng)
        x = int(np.clip(x, 0, image_height - rh))
        y = int(np.clip(y, 0, image_width - rw))
        masks.append(render(x, y))
    return masks


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
