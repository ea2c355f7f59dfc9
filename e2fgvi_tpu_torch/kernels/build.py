"""Build and load the port's CUDA kernels (``e2fgvi_tpu_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
process per source started together, linked into one shared library with
a plain C interface, and loaded with ``ctypes``. The library goes to ``build/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
at once. torch.utils.cpp_extension is not used: including PyTorch's headers
makes a build take minutes instead of seconds.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers (kernels/*.py) raise on nonzero.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every entry point: pointers and the stream as c_void_p (a
# plain int would be cut to 32 bits), sizes as c_int
_SIGNATURES = {
    "e2fgvi_deform_conv": [_I] + [_P] * 7 + [_I] * 10 + [_F, _I, _P],
    "e2fgvi_flow_warp": [_I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "e2fgvi_focal_attention": [_I] + [_P] * 5 + [_I] * 8 + [_P],
    "e2fgvi_band_sample": [_I, _I] + [_P] * 5 + [_I] * 11 + [_P],
    "e2fgvi_band_sample_cbatch": [_I] + [_P] * 5 + [_I] * 11 + [_P],
    "e2fgvi_band_sample_xpair": [_P] * 5 + [_I] * 11 + [_P],
    "e2fgvi_band_sample_cpair": [_P] * 5 + [_I] * 11 + [_P],
    "e2fgvi_row_gather": [_I, _I] + [_P] * 3 + [_I] * 4 + [_P],
    "e2fgvi_bilinear4_sample": [_P] * 5 + [_I] * 6 + [_P],
    "e2fgvi_band_attention": [_P] * 6 + [_I] * 12 + [_F, _I, _P],
    "e2fgvi_conv": [_P, _F, _I, _P],
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


def _run_all(cmds) -> str:
    """Run the commands at once; raise on the first that fails. Returns
    their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")
    return "".join(outs)


def build() -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, all at once, then one link.

    Returns (library path, nvcc's output: ptxas register and spill counts,
    kept beside the library as <name>.log, so a cached build returns the
    log of the build that made it; empty where that log is missing)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        log = _run_all([[nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", o,
                          str(p)] for p, o in zip(cu, objs)])
        lib = os.path.join(tmp, "lib.so")
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                          *objs]])
        log_path.write_text(log)
        os.replace(lib, out)
    return out, log


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
    the last two arguments of every entry point. The handle is read as
    PyTorch's generated kernels read it, without building a
    torch.cuda.Stream object a call."""
    import torch
    dev = t.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
