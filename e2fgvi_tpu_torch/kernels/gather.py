"""E3 (row-table gather) and E4 (4-corner bilinear sample): wrappers and
plain forms.

Counterpart of the TPU experiment kernels of scripts/exp_gather.py: `v2`
(inner `kernel` at :123, pallas_call :127) and `v3` (inner `kernel` at
:171, pallas_call :194). The CUDA kernels are in csrc/gather.cu; E4's entry
point launches two, the group-major rewrite of the table
(group_major_plain) and the sampler.

  row_gather(tab, idx)             out[t, p, j] = tab[idx[t, p, j], j]
  bilinear4_sample(tab, py, px, h, w)
      tab (h*w, C) float32, py/px (T, P, G) float32 -> (T, P, C): lane j
      samples group j % G (the TPU's pltpu.repeat tiles the G positions);
      corners y0 = clip(floor(py), 0, h-2), x0 = clip(floor(px), 0, w-2),
      weights relu(1 - |p - corner|), sum in the order (y0,x0), (y0,x0+1),
      (y0+1,x0), (y0+1,x0+1).

Each wrapper takes its plain version for tensors on the CPU, and only then;
for CUDA tensors it launches its kernel or raises. `LAUNCHES` counts each
wrapper's launches.
"""

import torch

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.kernels.deform import check_cuda_inputs, load_width

LAUNCHES = {"row_gather": 0, "bilinear4_sample": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# E4 stages a block's rows, and the group-major rewrite 32 table rows, of C
# floats each in shared memory
MAX_C = 1024


def row_gather_plain(tab, idx):
    """tab (P, C); idx (..., C) int in [0, P) -> (..., C) in tab's dtype."""
    flat = idx.reshape(-1, idx.shape[-1]).long()
    return torch.gather(tab, 0, flat).reshape(idx.shape)


def group_major_plain(tab, g):
    """tab (P, C) -> (G, P, C/G): out[g, p, k] = tab[p, k*G + g], the
    table as E4's sampler reads it."""
    p, c = tab.shape
    return tab.reshape(p, c // g, g).permute(2, 0, 1).contiguous()


def bilinear4_sample_plain(tab, py, px, h, w):
    """tab (h*w, C); py/px (T, P, G) -> (T, P, C) float32."""
    c = tab.shape[-1]
    g = py.shape[-1]
    pyl = py.float().repeat(1, 1, c // g)          # lane j -> group j % G
    pxl = px.float().repeat(1, 1, c // g)
    y0 = torch.clamp(torch.floor(pyl), 0, h - 2)
    x0 = torch.clamp(torch.floor(pxl), 0, w - 2)
    wy0 = torch.relu(1.0 - (pyl - y0).abs())
    wy1 = torch.relu(1.0 - (pyl - (y0 + 1.0)).abs())
    wx0 = torch.relu(1.0 - (pxl - x0).abs())
    wx1 = torch.relu(1.0 - (pxl - (x0 + 1.0)).abs())
    base = (y0 * w + x0).long()
    t = tab.float()

    def corner(off):
        return row_gather_plain(t, base + off)

    return (corner(0) * (wy0 * wx0) + corner(1) * (wy0 * wx1)
            + corner(w) * (wy1 * wx0) + corner(w + 1) * (wy1 * wx1))


def row_lanes(c: int, esize: int, tab_ptr: int, idx_ptr: int) -> int:
    """Lanes a thread of E3 takes: the widest of 8, 4, 2, 1 that divides C
    and at which both tab (esize-byte elements) and the int32 idx take
    loads as wide as `lanes` lanes allow (load_width; a view into a larger
    tensor may be aligned to less)."""
    for lanes in (8, 4, 2):
        if c % lanes == 0 and all(
                load_width(lanes, e, ptr) == min(lanes, 16 // e)
                for e, ptr in ((esize, tab_ptr), (4, idx_ptr))):
            return lanes
    return 1


def row_gather(tab, idx):
    """E3: a thread takes 8 consecutive lanes of an output row at a time
    (fewer where C or an alignment asks, row_lanes), one table row read
    where the lanes' indices agree, else one read a lane; 4 blocks an SM
    stride over the rows.

    tab (P, C) float32 or bfloat16; idx (..., C) int32. The kernel reads
    no row outside [0, P): an index outside gives 0 there (the plain
    version raises)."""
    if tab.is_cpu:
        return row_gather_plain(tab, idx)
    tab, idx = tab.contiguous(), idx.contiguous()
    check_cuda_inputs("row_gather", tab, idx)
    dtype = _DTYPES.get(tab.dtype)
    if dtype is None or idx.dtype != torch.int32:
        raise ValueError(f"row_gather: tab must be float32 or bfloat16 and "
                         f"idx int32, got {tab.dtype}, {idx.dtype}")
    if tab.dim() != 2 or idx.shape[-1] != tab.shape[1]:
        raise ValueError(f"row_gather: tab {tuple(tab.shape)} and idx "
                         f"{tuple(idx.shape)} do not agree")
    p, c = tab.shape
    out = torch.empty_like(idx, dtype=tab.dtype)
    tp, ip = tab.data_ptr(), idx.data_ptr()
    err = build.library().e2fgvi_row_gather(
        dtype, row_lanes(c, tab.element_size(), tp, ip), tp, ip,
        out.data_ptr(), idx.numel() // c, p, c, *build.stream_args(tab))
    build.check(err, "row_gather")
    LAUNCHES["row_gather"] += 1
    return out


def bilinear4_sample(tab, py, px, h, w):
    """E4: the table rewritten group-major, (G, h*w, C/G), into scratch
    made here (group_major_plain's layout); then the threads of a (t, p,
    group) (C/G / 4 of them, 4 channels each, where C/G % 4 == 0; else one)
    compute its clamped corners and four weights and read each corner's
    channels as one run.

    tab (h*w, C) float32, C a multiple of G and at most MAX_C; py/px (T, P,
    G) float32."""
    if tab.is_cpu:
        return bilinear4_sample_plain(tab, py, px, h, w)
    tab, py, px = tab.contiguous(), py.contiguous(), px.contiguous()
    check_cuda_inputs("bilinear4_sample", tab, py, px)
    if not tab.dtype == py.dtype == px.dtype == torch.float32:
        raise ValueError("bilinear4_sample: tab, py and px must be float32")
    c, g = tab.shape[-1], py.shape[-1]
    if (tab.dim() != 2 or tab.shape[0] != h * w or py.dim() != 3
            or px.shape != py.shape or c % g or h < 2 or w < 2):
        raise ValueError(f"bilinear4_sample: tab {tuple(tab.shape)}, py "
                         f"{tuple(py.shape)}, px {tuple(px.shape)} do not "
                         f"fit a {h}x{w} map")
    if c > MAX_C:
        raise ValueError(f"bilinear4_sample takes C <= {MAX_C} (a block's "
                         f"rows in shared memory); got {c}")
    t, p, _ = py.shape
    out = py.new_empty((t, p, c))
    tabg = py.new_empty((g, h * w, c // g))
    err = build.library().e2fgvi_bilinear4_sample(
        tab.data_ptr(), py.data_ptr(), px.data_ptr(), out.data_ptr(),
        tabg.data_ptr(), t * p, g, c, h, w, *build.stream_args(tab))
    build.check(err, "bilinear4_sample")
    LAUNCHES["bilinear4_sample"] += 1
    return out
