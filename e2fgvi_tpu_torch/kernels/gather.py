"""E3 (row-table gather) and E4 (4-corner bilinear sample): wrappers and
plain forms.

Counterpart of the TPU experiment kernels of scripts/exp_gather.py: `v2`
(inner `kernel` at :123, pallas_call :127) and `v3` (inner `kernel` at
:171, pallas_call :194). The CUDA kernels are in csrc/gather.cu.

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
from e2fgvi_tpu_torch.kernels.deform import check_cuda_inputs

LAUNCHES = {"row_gather": 0, "bilinear4_sample": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def row_gather_plain(tab, idx):
    """tab (P, C); idx (..., C) int in [0, P) -> (..., C) in tab's dtype."""
    flat = idx.reshape(-1, idx.shape[-1]).long()
    return torch.gather(tab, 0, flat).reshape(idx.shape)


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


def row_gather(tab, idx):
    """E3: one thread per output element, each with its own row index.

    tab (P, C) float32 or bfloat16; idx (..., C) int32. The kernel reads
    no row outside [0, P): an index outside gives 0 there (the plain
    version raises)."""
    if tab.device.type == "cpu":
        return row_gather_plain(tab, idx)
    tab, idx = tab.contiguous(), idx.contiguous()
    check_cuda_inputs("row_gather", tab, idx)
    if tab.dtype not in _DTYPES or idx.dtype != torch.int32:
        raise ValueError(f"row_gather: tab must be float32 or bfloat16 and "
                         f"idx int32, got {tab.dtype}, {idx.dtype}")
    if tab.dim() != 2 or idx.shape[-1] != tab.shape[1]:
        raise ValueError(f"row_gather: tab {tuple(tab.shape)} and idx "
                         f"{tuple(idx.shape)} do not agree")
    out = torch.empty(idx.shape, dtype=tab.dtype, device=tab.device)
    err = build.library().e2fgvi_row_gather(
        _DTYPES[tab.dtype], tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
        idx.numel() // tab.shape[1], tab.shape[0], tab.shape[1],
        *build.stream_args(tab))
    build.check(err, "row_gather")
    LAUNCHES["row_gather"] += 1
    return out


def bilinear4_sample(tab, py, px, h, w):
    """E4: one thread per (t, p, group) computes the clamped corners and
    the four weights once and writes the lanes g, g+G, ..., of its group.

    tab (h*w, C) float32; py/px (T, P, G) float32, C a multiple of G."""
    if tab.device.type == "cpu":
        return bilinear4_sample_plain(tab, py, px, h, w)
    tab, py, px = tab.contiguous(), py.contiguous(), px.contiguous()
    check_cuda_inputs("bilinear4_sample", tab, py, px)
    if any(t.dtype != torch.float32 for t in (tab, py, px)):
        raise ValueError("bilinear4_sample: tab, py and px must be float32")
    c, g = tab.shape[-1], py.shape[-1]
    if (tab.dim() != 2 or tab.shape[0] != h * w or py.dim() != 3
            or px.shape != py.shape or c % g or h < 2 or w < 2):
        raise ValueError(f"bilinear4_sample: tab {tuple(tab.shape)}, py "
                         f"{tuple(py.shape)}, px {tuple(px.shape)} do not "
                         f"fit a {h}x{w} map")
    t, p, _ = py.shape
    out = torch.empty((t, p, c), dtype=torch.float32, device=tab.device)
    err = build.library().e2fgvi_bilinear4_sample(
        tab.data_ptr(), py.data_ptr(), px.data_ptr(), out.data_ptr(), t * p,
        g, c, h, w, *build.stream_args(tab))
    build.check(err, "bilinear4_sample")
    LAUNCHES["bilinear4_sample"] += 1
    return out
