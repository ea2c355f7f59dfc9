"""Build and load the port's CUDA kernels (``e2fgvi_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, and loaded with ``ctypes``. The
library goes to ``build/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
at once. torch.utils.cpp_extension is not used: including PyTorch's headers
makes a build take minutes instead of seconds.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers (kernels/deform.py, kernels/focal_attention.py) raise on nonzero.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every entry point: pointers and the stream as c_void_p (a
# plain int would be cut to 32 bits), sizes as c_int
_SIGNATURES = {
    "e2fgvi_deform_im2col": [_I, _I, _P, _P, _P, _P, _P] + [_I] * 10
                            + [_F, _I, _P],
    "e2fgvi_flow_warp": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "e2fgvi_focal_attention": [_I] + [_P] * 8 + [_I] * 9 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit on the machine with the GPU")


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libe2fgvi_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns (library path, nvcc's output: ptxas register and spill counts,
    empty when nothing was compiled)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, *map(str, cu)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def stream_args(t) -> tuple[int, int]:
    """(device index, current stream handle) of a CUDA tensor's device:
    the last two arguments of every entry point."""
    import torch
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
