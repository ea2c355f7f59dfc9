"""ctypes bindings for the native host ops (csrc/host_ops.cpp): the iterated
3x3-cross mask dilation and the fused composite + blend.

Counterpart of e2fgvi_tpu/data/native.py, built from the port's own copy of
the source. g++ compiles it at first use into build/ at the repository root
(the directory of the CUDA kernels' library, kernels/build.py), named by a
hash of the source and flags, so an edited source rebuilds and an unchanged
one loads at once. Each build goes to a temporary name first and is moved
into place, so processes that build at the same time (pytest-xdist
workers) never load a half-written library. A failed build raises: the
port has no silent numpy fallback on its path. The numpy versions the ops
are held to are data/masks.dilate_cross and composite_blend_plain.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhost_ops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/host_ops.cpp unless the library for it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        done = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", lib],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed ({done.returncode}) on "
                               f"{SOURCE}:\n{done.stdout}{done.stderr}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.dilate_cross.argtypes = [u8, u8, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int]
    lib.dilate_cross.restype = None
    lib.composite_blend.argtypes = [f32, u8, u8, f32, f32, ctypes.c_int,
                                    ctypes.c_int]
    lib.composite_blend.restype = None
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dilate_cross(mask: np.ndarray, iterations: int = 4) -> np.ndarray:
    """Binary dilation of an (H, W) mask by the 3x3 cross, `iterations`
    times: uint8 {0, 1}, nonzero input pixels counting as set."""
    m = np.ascontiguousarray(mask, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"dilate_cross takes an (H, W) mask, not "
                         f"{m.shape}")
    out = np.empty_like(m)
    library().dilate_cross(_ptr(m, ctypes.c_uint8), _ptr(out, ctypes.c_uint8),
                           m.shape[0], m.shape[1], int(iterations))
    return out


def composite_blend_plain(pred, orig, mask, prev):
    """The composite in numpy (e2fgvi_tpu/data/native.py:78-80)."""
    img = (pred.astype(np.uint8) * mask[..., None] +
           orig * (1 - mask[..., None])).astype(np.float32)
    return img if prev is None else prev * 0.5 + img * 0.5


def composite_blend(pred: np.ndarray, orig: np.ndarray, mask: np.ndarray,
                    prev: np.ndarray | None) -> np.ndarray:
    """The prediction where the mask is set and the original elsewhere,
    50/50-blended with `prev` where given (reference test.py:168-179).

    pred: float32 (H, W, 3) in [0, 255], truncated to uint8 as the
    reference casts it; orig: uint8 (H, W, 3); mask: uint8 (H, W) in
    {0, 1}; prev: float32 (H, W, 3) or None. Returns float32 (H, W, 3)."""
    pred = np.ascontiguousarray(pred, np.float32)
    orig = np.ascontiguousarray(orig, np.uint8)
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    if pred.shape != (h, w, 3) or orig.shape != (h, w, 3) or (
            prev is not None and np.shape(prev) != (h, w, 3)):
        raise ValueError(f"composite_blend: pred {pred.shape}, orig "
                         f"{orig.shape}, mask {mask.shape}, prev "
                         f"{None if prev is None else np.shape(prev)}")
    out = np.empty_like(pred)
    if prev is None:
        prev_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    else:
        prev = np.ascontiguousarray(prev, np.float32)
        prev_ptr = _ptr(prev, ctypes.c_float)
    library().composite_blend(_ptr(pred, ctypes.c_float),
                              _ptr(orig, ctypes.c_uint8),
                              _ptr(mask, ctypes.c_uint8), prev_ptr,
                              _ptr(out, ctypes.c_float), h, w)
    return out
