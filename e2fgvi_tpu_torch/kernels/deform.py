"""K1 (head-fused DCNv2 sampler) and K2 (flow warp): wrappers and plain forms.

Counterpart of e2fgvi_tpu/kernels/dcn_band.py (modulated_deform_conv2d_
banded_head and flow_warp_banded). The CUDA kernels are in csrc/deform.cu.
The TPU kernel's band contract is not ported: the CUDA sampler gathers at
any offset exactly.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
only then. For CUDA tensors it launches its kernel or raises. Kernels are
forward-only: an input that requires grad raises. `LAUNCHES` counts the
kernel launches of each wrapper.
"""

import torch

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.ops.warp import flow_warp as flow_warp_plain
from e2fgvi_tpu_torch.ops.warp import grid_sample_bilinear

LAUNCHES = {"deform_im2col": 0, "flow_warp": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _channel_chunk(c: int, widest: int) -> int:
    for nc in (16, 8, 4, 2):
        if nc <= widest and c % nc == 0:
            return nc
    return 1


def check_cuda_inputs(name, *tensors):
    """Raise unless every tensor is a CUDA tensor on one device, contiguous
    and free of autograd history (the kernels are forward-only)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.requires_grad:
            raise RuntimeError(f"{name}: the kernel is forward-only; call "
                               "it under torch.no_grad()")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def offsets_from_head(head, flow_1, flow_2, max_residue=10.0, k=9):
    """Split the offset head into DCN offsets and mask (reference
    feat_prop.py:35-58; e2fgvi_tpu/models/feat_prop.py:_offsets_from_head).

    head: (N, H, W, 3*K*G); flow_1/flow_2: (N, H, W, 2) (dx, dy).
    Returns offsets (N, H, W, G, K, 2) in (dy, dx) order and mask
    (N, H, W, G, K), both float32. Groups [0, G/2) ride flow_1."""
    n, h, w, ch = head.shape
    g = ch // (3 * k)
    if ch != 3 * k * g:
        raise ValueError(f"offset-head channels {ch} not divisible by "
                         f"3*k={3 * k}")
    res = max_residue * torch.tanh(head[..., : 2 * k * g].float())
    res = res.reshape(n, h, w, g, k, 2)
    f1 = flow_1.float().flip(-1)[:, :, :, None, None, :]
    f2 = flow_2.float().flip(-1)[:, :, :, None, None, :]
    half = torch.zeros(g, device=head.device)
    half[g // 2:] = 1.0
    half = half[None, None, None, :, None, None]
    offsets = res + f1 * (1.0 - half) + f2 * half
    mask = torch.sigmoid(head[..., 2 * k * g:].float()).reshape(n, h, w, g, k)
    return offsets, mask


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, padding=1):
    """DCNv2 (stride 1, dilation 1, groups 1) as one F.grid_sample per tap
    (the form of tests/mmcv_shim.py), computed in float32.

    x: (N, H, W, Cin); offset: (N, Ho, Wo, G, K, 2) (dy, dx) pixels;
    mask: (N, Ho, Wo, G, K); weight: (Cout, Cin, kh, kw).
    Returns (N, Ho, Wo, Cout) in x's dtype."""
    n, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    _, ho, wo, g, k, _ = offset.shape
    cg = cin // g
    dev = x.device
    xg = x.float().reshape(n, h, w, g, cg).permute(0, 3, 1, 2, 4)
    xg = xg.reshape(n * g, h, w, cg)
    ys = torch.arange(ho, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(wo, dtype=torch.float32, device=dev)[None, :, None]
    off = offset.float()
    m = mask.float()
    cols = []
    for t in range(k):
        ky, kx = t // kw, t % kw
        py = ys - padding + ky + off[..., t, 0]          # (N, Ho, Wo, G)
        px = xs - padding + kx + off[..., t, 1]
        gy = 2.0 * py / max(h - 1, 1) - 1.0
        gx = 2.0 * px / max(w - 1, 1) - 1.0
        grid = torch.stack([gx, gy], -1).permute(0, 3, 1, 2, 4)
        samp = grid_sample_bilinear(xg, grid.reshape(n * g, ho, wo, 2))
        samp = samp.reshape(n, g, ho, wo, cg) \
            * m[..., t].permute(0, 3, 1, 2)[..., None]
        cols.append(samp)
    cols = torch.stack(cols, 2)                          # (N, G, K, Ho, Wo, CG)
    w4 = weight.float().reshape(cout, g, cg, k)
    out = torch.einsum("ngkyxc,ogck->nyxo", cols, w4)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def deform_conv_head_plain(x, head, flow_1, flow_2, weight, bias=None,
                           max_residue=10.0, padding=1):
    """Plain version of K1: offsets_from_head, then the per-tap DCN."""
    k = weight.shape[2] * weight.shape[3]
    offsets, mask = offsets_from_head(head, flow_1, flow_2, max_residue, k)
    return modulated_deform_conv2d(x, offsets, mask, weight, bias, padding)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def deform_im2col(x, head, flow_1, flow_2, kh=3, kw=3, padding=1,
                  max_residue=10.0):
    """Launch K1: the offset/mask prelude and the bilinear sampling.

    x: (N, H, W, Cin) CUDA, float32 or bfloat16; head: (N, Ho, Wo, 3*K*G)
    in x's dtype; flows (N, Ho, Wo, 2) float32. Returns the im2col matrix
    (N*Ho*Wo, G*K*CG) in x's dtype, row n*P + p, column (g*K + k)*CG + c."""
    x, head = x.contiguous(), head.contiguous()
    flow_1 = flow_1.float().contiguous()
    flow_2 = flow_2.float().contiguous()
    check_cuda_inputs("deform_im2col", x, head, flow_1, flow_2)
    if x.dtype not in _DTYPES or head.dtype != x.dtype:
        raise ValueError(f"deform_im2col: x {x.dtype} / head {head.dtype} "
                         "must both be float32 or bfloat16")
    n, h, w, cin = x.shape
    k = kh * kw
    _, ho, wo, ch = head.shape
    g = ch // (3 * k)
    if ch != 3 * k * g or g == 0 or cin % g:
        raise ValueError(f"deform_im2col: head channels {ch} do not fit "
                         f"{k} taps and Cin={cin}")
    if ho != h + 2 * padding - kh + 1 or wo != w + 2 * padding - kw + 1:
        raise ValueError("deform_im2col: head size does not match the conv")
    if flow_1.shape != (n, ho, wo, 2) or flow_2.shape != (n, ho, wo, 2):
        raise ValueError("deform_im2col: flows must be (N, Ho, Wo, 2)")
    cg = cin // g
    col = torch.empty((n * ho * wo, g * k * cg), dtype=x.dtype,
                      device=x.device)
    err = build.library().e2fgvi_deform_im2col(
        _DTYPES[x.dtype], _channel_chunk(cg, 16), x.data_ptr(),
        head.data_ptr(), flow_1.data_ptr(), flow_2.data_ptr(),
        col.data_ptr(), n, h, w, cin, ho, wo, g, k, kw, padding,
        float(max_residue), *build.stream_args(x))
    build.check(err, "deform_im2col")
    LAUNCHES["deform_im2col"] += 1
    return col


def modulated_deform_conv2d_head(x, head, flow_1, flow_2, weight, bias=None,
                                 max_residue=10.0, padding=1):
    """Head-fused DCNv2 (e2fgvi_tpu kernels/dcn_band.py:650).

    x: (N, H, W, Cin); head: (N, Ho, Wo, 3*K*G) raw offset-head output
    (offset channel (g*K + k)*2 + {dy, dx}, mask channel 2*K*G + g*K + k);
    flow_1/flow_2: (N, Ho, Wo, 2) (dx, dy); weight: (Cout, Cin, kh, kw).
    Returns (N, Ho, Wo, Cout) in x's dtype.

    CPU tensors take the plain version. On CUDA, K1 writes the im2col
    matrix and one GEMM applies the weight, reordered to (g, k, cg) x Cout;
    the JAX package also contracts outside its kernel."""
    if x.device.type == "cpu":
        return deform_conv_head_plain(x, head, flow_1, flow_2, weight, bias,
                                      max_residue, padding)
    cout, cin, kh, kw = weight.shape
    k = kh * kw
    g = head.shape[-1] // (3 * k)
    col = deform_im2col(x, head, flow_1, flow_2, kh, kw, padding,
                        max_residue)
    w_r = weight.to(x.dtype).reshape(cout, g, cin // g, k)
    w_r = w_r.permute(1, 3, 2, 0).reshape(g * k * (cin // g), cout)
    if bias is None:
        out = col @ w_r
    else:
        out = torch.addmm(bias.to(x.dtype), col, w_r)
    n = x.shape[0]
    return out.reshape(n, head.shape[1], head.shape[2], cout)


def flow_warp(x, flow):
    """Backward warp, bilinear, zeros outside, align_corners=True
    (e2fgvi_tpu kernels/dcn_band.py:434 and ops/warp.py:53).

    x: (N, H, W, C) float32 or bfloat16; flow: (N, H, W, 2) (dx, dy).
    CPU tensors take ops.warp.flow_warp; CUDA tensors launch K2."""
    if x.device.type == "cpu":
        return flow_warp_plain(x, flow)
    x = x.contiguous()
    flow = flow.float().contiguous()
    check_cuda_inputs("flow_warp", x, flow)
    if x.dtype not in _DTYPES:
        raise ValueError(f"flow_warp: unsupported dtype {x.dtype}")
    n, h, w, c = x.shape
    if flow.shape != (n, h, w, 2):
        raise ValueError(f"flow_warp: flow {tuple(flow.shape)} does not "
                         f"match image {tuple(x.shape)}")
    out = torch.empty_like(x)
    err = build.library().e2fgvi_flow_warp(
        _DTYPES[x.dtype], _channel_chunk(c, 8), x.data_ptr(),
        flow.data_ptr(), out.data_ptr(), n, h, w, c, *build.stream_args(x))
    build.check(err, "flow_warp")
    LAUNCHES["flow_warp"] += 1
    return out
