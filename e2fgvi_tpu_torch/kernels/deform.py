"""K1 (head-fused DCNv2) and K2 (flow warp): wrappers and plain forms.

Counterpart of e2fgvi_tpu/kernels/dcn_band.py (modulated_deform_conv2d_
banded_head and flow_warp_banded). The CUDA kernels are in csrc/deform.cu.
The TPU kernel's band contract is not ported: the CUDA sampler gathers at
any offset exactly.

K1 is one kernel in both dtypes, sampler and contraction together
(deform_conv_fused): wgmma on bf16 for bfloat16, on 3xTF32 for float32.
Each wrapper takes its plain PyTorch version for tensors on the CPU, and
only then. For CUDA tensors it launches its kernel or raises. Where grad
mode is on and an input requires grad, the wrapper goes through an
autograd Function (DeformConvHead, FlowWarp): the kernel runs forward on
detached inputs, and the backward recomputes the plain version and returns
its vector-Jacobian product, as the JAX package's fused attention does
(e2fgvi_tpu/kernels/fused_attention.py:_bwd); no kernel has a backward of
its own. The plain versions sample at pixel positions (ops.warp.
bilinear_sample), as the JAX package's K1 and K2 do. `LAUNCHES` counts the
kernel launches of each wrapper; "deform_conv" counts K1 in both dtypes.

K1's weight and bias, reordered (and in float32 split) for its contraction
(conv_operands), are made once by a caller that runs one weight many times
(models/feat_prop.py) and passed in as `operands`. Misaligned data: K2's
loads are as wide as its x's alignment allows (the same kernel at a
narrower load width); any other input the kernels read in vector loads
(the flows, K1's x and head) is copied to an aligned tensor where it is
not aligned.
"""

from typing import NamedTuple

import torch

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.ops.warp import bilinear_sample
from e2fgvi_tpu_torch.ops.warp import flow_warp as flow_warp_plain

LAUNCHES = {"deform_conv": 0, "flow_warp": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K1's contract: 16 channels a group (E2FGVI's second-order DCN, Cin 256)
# or 8 (ProPainter's first-order DCN, Cin 128), 128 output channels (the
# wgmma's n), and whole K chunks of (group, tap) slices: 64 wide in
# bfloat16 (4 k16 steps), 32 in float32 (one 128-byte row of 32 floats, 4
# tf32 k8 steps)
FUSED_CG, FUSED_COUT = 16, 128
FUSED_CGS = (16, 8)
FUSED_CHUNK = {torch.bfloat16: 64, torch.float32: 32}


def _channel_chunk(c: int, widest: int) -> int:
    for nc in (16, 8, 4, 2):
        if nc <= widest and c % nc == 0:
            return nc
    return 1


def _aligned(t, nbytes: int):
    """t, or an aligned copy of it where its data is not nbytes-aligned (a
    view into a larger tensor); the allocator aligns every new tensor."""
    return t.clone() if t.data_ptr() % nbytes else t


def load_width(nc: int, esize: int, addr: int) -> int:
    """Elements per load for a thread's nc channels: the widest power of
    two up to nc and 16 bytes at which the data at `addr` is aligned."""
    vec = min(nc, 16 // esize)
    while addr % (vec * esize):
        vec //= 2
    return vec


def check_cuda_inputs(name, *tensors):
    """Raise unless every tensor is a CUDA tensor on one device, contiguous
    and free of autograd history: a kernel launch is forward-only, and
    gradients go through the wrappers' autograd Functions."""
    dev = tensors[0].get_device()                # -1 on the CPU
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device, got {t.device} and "
                             f"{tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: a kernel launch is forward-only; K1, K2, K3 and C1 "
                "take inputs that require grad through their wrappers' "
                "autograd Functions (kernels.deform.DeformConvHead, FlowWarp, "
                "kernels.focal_attention.FocalAttention, kernels.conv."
                "Conv3x3), other kernels run under torch.no_grad()")


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


def _sample_columns(x, offset, mask, kw, padding):
    """The masked bilinear samples of DCNv2 in float32 at pixel positions,
    (N, G, K, Ho, Wo, CG): one four-corner gather (ops.warp.
    bilinear_sample) over every group and tap, as e2fgvi_tpu/ops/dcn.py:
    modulated_deform_conv2d samples."""
    n, h, w, cin = x.shape
    _, ho, wo, g, k, _ = offset.shape
    cg = cin // g
    dev = x.device
    xg = x.float().reshape(n, h, w, g, cg).permute(0, 3, 1, 2, 4)
    xg = xg.reshape(n * g, h, w, cg)
    taps = torch.arange(k, device=dev)
    ky, kx = (taps // kw).float(), (taps % kw).float()
    base_y = torch.arange(ho, dtype=torch.float32, device=dev)[:, None] \
        - padding + ky                                     # (Ho, K)
    base_x = torch.arange(wo, dtype=torch.float32, device=dev)[:, None] \
        - padding + kx                                     # (Wo, K)
    off = offset.float()
    py = base_y[None, :, None, None, :] + off[..., 0]      # (N, Ho, Wo, G, K)
    px = base_x[None, None, :, None, :] + off[..., 1]

    def per_group(p):                                      # (N*G, K*Ho*Wo)
        return p.permute(0, 3, 4, 1, 2).reshape(n * g, k * ho * wo)

    samp = bilinear_sample(xg, per_group(py), per_group(px))
    m = mask.float().permute(0, 3, 4, 1, 2)[..., None]     # (N, G, K, Ho, Wo)
    return samp.reshape(n, g, k, ho, wo, cg) * m


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, padding=1):
    """DCNv2 (stride 1, dilation 1, groups 1) in float32: the four-corner
    samples of every group and tap (_sample_columns), then one contraction.

    x: (N, H, W, Cin); offset: (N, Ho, Wo, G, K, 2) (dy, dx) pixels;
    mask: (N, Ho, Wo, G, K); weight: (Cout, Cin, kh, kw).
    Returns (N, Ho, Wo, Cout) in x's dtype."""
    cout, cin, _, kw = weight.shape
    _, _, _, g, k, _ = offset.shape
    cols = _sample_columns(x, offset, mask, kw, padding)
    w4 = weight.float().reshape(cout, g, cin // g, k)
    out = torch.einsum("ngkyxc,ogck->nyxo", cols, w4)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def deform_columns_plain(x, head, flow_1, flow_2, kh=3, kw=3, padding=1,
                         max_residue=10.0):
    """K1's im2col matrix in float32, (N*Ho*Wo, G*K*CG), row n*P + p,
    column (g*K + k)*CG + c: the A operand that the kernels sample into
    shared memory tile by tile."""
    offsets, mask = offsets_from_head(head, flow_1, flow_2, max_residue,
                                      kh * kw)
    cols = _sample_columns(x, offsets, mask, kw, padding)
    n, g, k, ho, wo, cg = cols.shape
    return cols.permute(0, 3, 4, 1, 2, 5).reshape(n * ho * wo, g * k * cg)


def fused_weight(weight, dtype=None, groups=None):
    """The weight (Cout, Cin, kh, kw) as the fused K1's B operand: (Cout,
    G*K*CG), K-major, column (g*K + k)*CG + c, in `dtype` (default the
    weight's); G defaults to Cin / 16, the fused kernel's. The transpose of
    the im2col GEMM's (g, k, cg) x Cout."""
    cout, cin, kh, kw = weight.shape
    g = cin // FUSED_CG if groups is None else groups
    w = weight if dtype is None else weight.to(dtype)
    w = w.reshape(cout, g, cin // g, kh * kw).permute(0, 1, 3, 2)
    return w.reshape(cout, cin * kh * kw).contiguous()


def split_tf32(t):
    """(big, small): float32 t split into two tf32 values (13 low mantissa
    bits zero) by the kernels' integer rounding, nearest with ties away
    from zero (cvt.rna.tf32.f32 on finite values): big = rna(t), small =
    rna(t - big). big + small is t to within 2^-22 |t|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    big = rna(t)
    return big, rna(t - big)


class ConvOperands(NamedTuple):
    """K1's weight and bias as the fused kernel contracts them: the B
    operand K-major, column (g*K + k)*CG + c (fused_weight) — in bfloat16
    (Cout, K); in float32 (2, Cout, K), its tf32 big then small parts
    (split_tf32) — and the bias in float32 (in bfloat16 rounded to bf16
    first), zeros where there is none."""
    weight: torch.Tensor
    bias: torch.Tensor


def conv_operands(weight, bias, dtype, groups=None) -> ConvOperands:
    """K1's weight (Cout, Cin, kh, kw) and bias (Cout,) or None, reordered
    for inputs of `dtype` and G `groups` (default Cin / 16, the fused
    kernel's): made once for every call that uses one weight."""
    weight = weight.detach()
    if bias is None:
        b32 = torch.zeros(weight.shape[0], dtype=torch.float32,
                          device=weight.device)
    else:
        b32 = bias.detach().to(dtype).float().contiguous()
    wk = fused_weight(weight, dtype, groups)
    if dtype == torch.float32:
        wk = torch.stack(split_tf32(wk))
    return ConvOperands(wk, b32)


def deform_conv_head_plain(x, head, flow_1, flow_2, weight, bias=None,
                           max_residue=10.0, padding=1):
    """Plain version of K1: offsets_from_head, then the per-tap DCN."""
    k = weight.shape[2] * weight.shape[3]
    offsets, mask = offsets_from_head(head, flow_1, flow_2, max_residue, k)
    return modulated_deform_conv2d(x, offsets, mask, weight, bias, padding)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _conv_geometry(name, x, head, flow_1, flow_2, kh, kw, padding):
    """Check K1's inputs against each other; returns (n, h, w, cin, ho, wo,
    g, k)."""
    n, h, w, cin = x.shape
    k = kh * kw
    _, ho, wo, ch = head.shape
    g = ch // (3 * k)
    if ch != 3 * k * g or g == 0 or cin % g:
        raise ValueError(f"{name}: head channels {ch} do not fit {k} taps "
                         f"and Cin={cin}")
    if ho != h + 2 * padding - kh + 1 or wo != w + 2 * padding - kw + 1:
        raise ValueError(f"{name}: head size does not match the conv")
    if flow_1.shape != (n, ho, wo, 2) or flow_2.shape != (n, ho, wo, 2):
        raise ValueError(f"{name}: flows must be (N, Ho, Wo, 2)")
    return n, h, w, cin, ho, wo, g, k


def check_fused_shapes(x, head, weight):
    """Raise unless the fused K1 takes these shapes: Cin = 16 G or 8 G
    (16 or 8 channels a group), Cout = 128 (the wgmma's n) and whole K
    chunks: G*kh*kw*CG a multiple of 64 in bfloat16, of 32 in float32 (at
    CG 16: G*kh*kw a multiple of 4, or even); in float32 also an image of
    x under 2^31 elements."""
    cout, cin, kh, kw = weight.shape
    k = kh * kw
    g = head.shape[-1] // (3 * k)
    if x.shape[-1] != cin:
        raise ValueError(f"deform_conv_fused: x has {x.shape[-1]} channels, "
                         f"the weight {cin}")
    if g == 0 or cin % g or cin // g not in FUSED_CGS:
        raise ValueError(f"deform_conv_fused takes Cin = 16 * G or 8 * G "
                         f"(CG == 16 or 8); got Cin={cin}, G={g}")
    if cout != FUSED_COUT:
        raise ValueError(f"deform_conv_fused takes Cout == {FUSED_COUT}; "
                         f"got {cout}")
    chunk = FUSED_CHUNK[x.dtype]
    per = chunk // (cin // g)        # slices a K chunk
    if (g * k) % per:
        rule = "even" if per == 2 else f"a multiple of {per}"
        raise ValueError(f"deform_conv_fused takes G*kh*kw {rule} at CG "
                         f"{cin // g} in {x.dtype} (whole {chunk}-wide K "
                         f"chunks); got G={g}, {kh}x{kw} taps")
    if x.dtype == torch.float32 and x[0].numel() >= 2 ** 31:
        raise ValueError("deform_conv_fused takes images of x under 2^31 "
                         "elements in float32 (32-bit corner offsets)")


def deform_conv_fused(x, head, flow_1, flow_2, weight, bias=None,
                      max_residue=10.0, padding=1, operands=None):
    """Launch K1: sampler and contraction in one kernel.

    x: (N, H, W, Cin) CUDA bfloat16 or float32; head: (N, Ho, Wo, 3*K*G)
    of x's dtype; flows (N, Ho, Wo, 2) float32; weight (128, Cin, kh, kw);
    bias (128,) or None; operands: conv_operands(weight, bias, x.dtype, G),
    made here when None. Returns (N, Ho, Wo, 128) of x's dtype. Shapes
    outside check_fused_shapes' contract raise."""
    # CG 8 reads a bf16 head row's 8 slices in 16-byte loads
    x = _aligned(x.contiguous(), 16)
    head = _aligned(head.contiguous(),
                    16 if x.shape[-1] * 27 == 8 * head.shape[-1] else 8)
    flow_1 = _aligned(flow_1.float().contiguous(), 8)
    flow_2 = _aligned(flow_2.float().contiguous(), 8)
    check_cuda_inputs("deform_conv_fused", x, head, flow_1, flow_2)
    if x.dtype not in FUSED_CHUNK or head.dtype != x.dtype:
        raise ValueError(f"deform_conv_fused: x {x.dtype} / head "
                         f"{head.dtype} must both be bfloat16 or float32")
    cout, _, kh, kw = weight.shape
    n, h, w, cin, ho, wo, g, k = _conv_geometry(
        "deform_conv_fused", x, head, flow_1, flow_2, kh, kw, padding)
    check_fused_shapes(x, head, weight)
    if operands is None:
        operands = conv_operands(weight, bias, x.dtype, g)
    wk, b32 = operands
    if wk.device != x.device or b32.device != x.device:
        raise ValueError("deform_conv_fused: the weight and bias must be on "
                         f"x's device {x.device}")
    if wk.dtype != x.dtype:
        raise ValueError(f"deform_conv_fused: operands of {wk.dtype} for x "
                         f"of {x.dtype}")
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    err = build.library().e2fgvi_deform_conv(
        _DTYPES[x.dtype], x.data_ptr(), head.data_ptr(), flow_1.data_ptr(),
        flow_2.data_ptr(), wk.data_ptr(), b32.data_ptr(), out.data_ptr(), n,
        h, w, cin, ho, wo, g, k, kw, padding, float(max_residue),
        *build.stream_args(x))
    build.check(err, "deform_conv_fused")
    LAUNCHES["deform_conv"] += 1
    return out


def differentiable(*tensors) -> bool:
    """True where grad mode is on and a tensor requires grad: the wrappers
    then take their autograd Function, else the kernel directly."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_vjp(ctx, plain, grad, *static):
    """The backward of a kernel's autograd Function: the plain version
    recomputed on the saved inputs under grad mode, and its vector-Jacobian
    product with grad for each input that needs one (None elsewhere, and
    for the `static` arguments after the saved tensors)."""
    saved = ctx.saved_tensors
    ins = [None if t is None else t.detach().requires_grad_(need)
           for t, need in zip(saved, ctx.needs_input_grad)]
    wrt = [t for t in ins if t is not None and t.requires_grad]
    with torch.enable_grad():
        out = plain(*ins, *static)
    got = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
    grads = [next(got) if t is not None and t.requires_grad else None
             for t in ins]
    return (*grads, *(None,) * (len(ctx.needs_input_grad) - len(saved)))


class DeformConvHead(torch.autograd.Function):
    """K1 with a gradient: forward launches the fused kernel on detached
    inputs; backward recomputes deform_conv_head_plain and returns its VJP
    in x, the offset head, both flows, the weight and the bias. `operands`
    is made from the live weight by the caller on every forward pass."""

    @staticmethod
    def forward(ctx, x, head, flow_1, flow_2, weight, bias, max_residue,
                padding, operands):
        ctx.save_for_backward(x, head, flow_1, flow_2, weight, bias)
        ctx.static = (max_residue, padding)
        return deform_conv_fused(
            x.detach(), head.detach(), flow_1.detach(), flow_2.detach(),
            weight.detach(), None if bias is None else bias.detach(),
            max_residue, padding, operands)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(ctx, deform_conv_head_plain, grad, *ctx.static)


def modulated_deform_conv2d_head(x, head, flow_1, flow_2, weight, bias=None,
                                 max_residue=10.0, padding=1, operands=None):
    """Head-fused DCNv2 (e2fgvi_tpu kernels/dcn_band.py:650).

    x: (N, H, W, Cin); head: (N, Ho, Wo, 3*K*G) raw offset-head output
    (offset channel (g*K + k)*2 + {dy, dx}, mask channel 2*K*G + g*K + k);
    flow_1/flow_2: (N, Ho, Wo, 2) (dx, dy); weight: (Cout, Cin, kh, kw).
    Returns (N, Ho, Wo, Cout) in x's dtype. operands: conv_operands(weight,
    bias, x.dtype), made here when None.

    CPU tensors take the plain version; CUDA tensors the fused kernel
    (deform_conv_fused), whose contract other shapes fail, through
    DeformConvHead where an input requires grad."""
    if x.device.type == "cpu":
        return deform_conv_head_plain(x, head, flow_1, flow_2, weight, bias,
                                      max_residue, padding)
    if differentiable(x, head, flow_1, flow_2, weight, bias):
        return DeformConvHead.apply(x, head, flow_1, flow_2, weight, bias,
                                    max_residue, padding, operands)
    return deform_conv_fused(x, head, flow_1, flow_2, weight, bias,
                             max_residue, padding, operands)


class FlowWarp(torch.autograd.Function):
    """K2 with a gradient: forward launches the kernel on detached inputs;
    backward recomputes ops.warp.flow_warp and returns its VJP in x and the
    flow."""

    @staticmethod
    def forward(ctx, x, flow):
        ctx.save_for_backward(x, flow)
        return flow_warp_kernel(x.detach(), flow.detach())

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(ctx, flow_warp_plain, grad)


def flow_warp(x, flow):
    """Backward warp, bilinear, zeros outside, align_corners=True
    (e2fgvi_tpu kernels/dcn_band.py:434 and ops/warp.py:53).

    x: (N, H, W, C) float32 or bfloat16; flow: (N, H, W, 2) (dx, dy).
    CPU tensors take ops.warp.flow_warp; CUDA tensors launch K2
    (flow_warp_kernel), through FlowWarp where an input requires grad."""
    if x.is_cpu:
        return flow_warp_plain(x, flow)
    if differentiable(x, flow):
        return FlowWarp.apply(x, flow)
    return flow_warp_kernel(x, flow)


def flow_warp_kernel(x, flow):
    """Launch K2 on CUDA tensors: threads take 16 bytes of channels each
    (fewer where C is not a multiple) in loads as wide as x's alignment
    allows."""
    x = x.contiguous()
    flow = flow.float().contiguous()
    check_cuda_inputs("flow_warp", x, flow)
    if x.dtype not in _DTYPES:
        raise ValueError(f"flow_warp: unsupported dtype {x.dtype}")
    n, h, w, c = x.shape
    if flow.shape != (n, h, w, 2):
        raise ValueError(f"flow_warp: flow {tuple(flow.shape)} does not "
                         f"match image {tuple(x.shape)}")
    flow = _aligned(flow, 8)                # read as one float2 a pixel
    out = torch.empty_like(x)
    esize, xp = x.element_size(), x.data_ptr()
    nc = _channel_chunk(c, 16 // esize)
    err = build.library().e2fgvi_flow_warp(
        _DTYPES[x.dtype], nc, load_width(nc, esize, xp), xp,
        flow.data_ptr(), out.data_ptr(), n, h, w, c, *build.stream_args(x))
    build.check(err, "flow_warp")
    LAUNCHES["flow_warp"] += 1
    return out
