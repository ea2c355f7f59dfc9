"""C1 (feat_prop's float32 3x3 convolutions): wrapper and plain form.

The CUDA kernel is in csrc/conv.cu (namespace conv_tf32): an implicit GEMM
on 3xTF32 wgmma for float32 NHWC inputs, 3x3, stride 1, padding 1, Cout
128 or 432, with the bias, an optional LeakyReLU and an optional residual
add in its epilogue. It has no TPU counterpart: the JAX package left these
convolutions to XLA.

`conv3x3` takes its plain version (ops.convs.conv2d, then the epilogue
written out) for tensors on the CPU, and only then. For CUDA tensors it
launches the kernel or raises. Where grad mode is on and an input requires
grad it goes through the autograd Function Conv3x3: the kernel runs forward
on detached inputs, and the backward is the plain version's vector-Jacobian
product, as K1's and K3's are (kernels/deform.py plain_vjp). `LAUNCHES`
counts the kernel's launches.

The weight reordered and split for the kernel (conv_operands) is made once
by a caller that runs one weight many times (models/feat_prop.py, once a
propagation) and passed in as `operands`.
"""

import torch

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.kernels.deform import (ConvOperands, _aligned,
                                             check_cuda_inputs,
                                             differentiable, plain_vjp,
                                             split_tf32)
from e2fgvi_tpu_torch.ops.convs import conv2d, leaky_relu

LAUNCHES = {"conv3x3": 0}

COUTS = (128, 432)          # the N-tiles the kernel has: 128 and 3 x 144
CHUNK = 32                  # K chunk: 32 channels of one tap


def conv3x3_plain(x, weight, bias=None, residual=None, negative_slope=None):
    """Plain version of C1: ops.convs.conv2d (3x3, padding 1), then
    LeakyReLU(negative_slope) where given, then residual + the result
    where given. x (N, H, W, Cin), weight (Cout, Cin, 3, 3) -> (N, H, W,
    Cout), in x's dtype."""
    y = conv2d(x, weight, bias, padding=1)
    if negative_slope is not None:
        y = leaky_relu(y, negative_slope)
    if residual is not None:
        y = residual + y
    return y


def check_shapes(x, weight, stride=1, padding=1, residual=None):
    """Raise ValueError unless C1 takes these: float32 x (N, H, W, Cin),
    contiguous, Cin a multiple of 4 (the input's rows are 16-byte
    multiples for TMA); a 3x3 weight (Cout, Cin, 3, 3), Cout 128 or 432;
    stride 1, padding 1; a residual of the output's shape and dtype,
    contiguous."""
    if x.dtype != torch.float32:
        raise ValueError(f"conv3x3 takes float32 inputs; got {x.dtype}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError("conv3x3 takes x (N, H, W, Cin) and a weight "
                         "(Cout, Cin, kh, kw)")
    cout, cin, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"conv3x3 takes a 3x3 kernel; got {kh}x{kw}")
    if stride != 1 or padding != 1:
        raise ValueError(f"conv3x3 takes stride 1 and padding 1; got stride "
                         f"{stride}, padding {padding}")
    if x.shape[-1] != cin:
        raise ValueError(f"conv3x3: x has {x.shape[-1]} channels, the "
                         f"weight {cin}")
    if cin % 4:
        raise ValueError(f"conv3x3 takes Cin a multiple of 4; got {cin}")
    if cout not in COUTS:
        raise ValueError(f"conv3x3 takes Cout in {COUTS}; got {cout}")
    if not x.is_contiguous():
        raise ValueError("conv3x3 takes a contiguous x")
    if residual is not None and (
            residual.shape != (*x.shape[:3], cout)
            or residual.dtype != torch.float32
            or not residual.is_contiguous()):
        raise ValueError("conv3x3: the residual must be a contiguous float32 "
                         "(N, H, W, Cout) tensor")


def conv_weight(weight):
    """The weight (Cout, Cin, kh, kw) as C1's (3x3) or C2's
    (kernels/raft_conv.py) B operand in float32: (Cout, kh * kw * Cin_pad),
    K-major, Cin_pad = Cin rounded up to 32 with zero channels; chunk
    q = c * kh * kw + tap (tap = kw ky + kx) holds channels 32c .. 32c + 31
    of that tap, column 8kk + j of the chunk channel 8 (j % 4) + 2kk +
    j // 4: thread t of a quad hands the wgmma's k-step kk its channels
    8t + 2kk (k-column t) and 8t + 2kk + 1 (k-column t + 4)."""
    cout, cin, kh, kw = weight.shape
    chunks = -(-cin // CHUNK)
    w = weight.new_zeros((cout, chunks * CHUNK, kh, kw), dtype=torch.float32)
    w[:, :cin] = weight.float()
    # channel (t, kk, h) = 8t + 2kk + h to column (kk, h, t), as a view:
    # no index tensor to upload
    w = w.reshape(cout, chunks, 4, 4, 2, kh * kw).permute(0, 1, 5, 3, 4, 2)
    return w.reshape(cout, chunks * kh * kw * CHUNK).contiguous()


def conv_operands(weight, bias) -> ConvOperands:
    """C1's weight and bias: conv_weight's B operand split into its tf32
    big and small parts (kernels.deform.split_tf32), (2, Cout, K), and the
    bias in float32 (zeros where there is none); made once for every call
    that uses one weight."""
    weight = weight.detach()
    wk = torch.stack(split_tf32(conv_weight(weight))).contiguous()
    if bias is None:
        b32 = torch.zeros(weight.shape[0], dtype=torch.float32,
                          device=weight.device)
    else:
        b32 = bias.detach().float().contiguous()
    return ConvOperands(wk, b32)


def conv3x3_kernel(x, weight, bias=None, residual=None, negative_slope=None,
                   operands=None):
    """Launch C1 on CUDA tensors (check_shapes' contract); operands:
    conv_operands(weight, bias), made here when None."""
    check_shapes(x, weight, residual=residual)
    x = _aligned(x, 16)
    ins = (x,) if residual is None else (x, residual)
    check_cuda_inputs("conv3x3", *ins)
    if operands is None:
        operands = conv_operands(weight, bias)
    wk, b32 = operands
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if wk.shape != (2, cout, 9 * -(-cin // CHUNK) * CHUNK) or \
            b32.shape != (cout,):
        raise ValueError("conv3x3: operands do not match the weight")
    if wk.device != x.device or b32.device != x.device:
        raise ValueError(f"conv3x3: the operands must be on x's device "
                         f"{x.device}")
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=x.device)
    res = 0 if residual is None else _aligned(residual, 8).data_ptr()
    err = build.library().e2fgvi_conv3x3(
        x.data_ptr(), wk.data_ptr(), b32.data_ptr(), res, out.data_ptr(), n,
        h, w, cin, cout, 1.0 if negative_slope is None else negative_slope,
        *build.stream_args(x))
    build.check(err, "conv3x3")
    LAUNCHES["conv3x3"] += 1
    return out


class Conv3x3(torch.autograd.Function):
    """C1 with a gradient: forward launches the kernel on detached inputs;
    backward recomputes conv3x3_plain and returns its VJP in x, the weight,
    the bias and the residual. `operands` is made from the live weight by
    the caller on every forward pass."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, negative_slope, operands):
        ctx.save_for_backward(x, weight, bias, residual)
        ctx.static = (negative_slope,)
        return conv3x3_kernel(
            x.detach(), weight.detach(),
            None if bias is None else bias.detach(),
            None if residual is None else residual.detach(), negative_slope,
            operands)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(ctx, conv3x3_plain, grad, *ctx.static)


def conv3x3(x, weight, bias=None, stride=1, padding=1, negative_slope=None,
            residual=None, operands=None):
    """A float32 3x3 convolution (NHWC, stride 1, padding 1) with its bias,
    then LeakyReLU(negative_slope) where given, then residual + the result
    where given: C1.

    x (N, H, W, Cin); weight (Cout, Cin, 3, 3); bias (Cout,) or None;
    residual (N, H, W, Cout) or None; operands: conv_operands(weight,
    bias), made here when None. Inputs outside check_shapes' contract raise
    ValueError on every device. CPU tensors take conv3x3_plain; CUDA
    tensors the kernel, through Conv3x3 where an input requires grad."""
    check_shapes(x, weight, stride, padding, residual)
    if x.is_cpu:
        return conv3x3_plain(x, weight, bias, residual, negative_slope)
    if differentiable(x, weight, bias, residual):
        return Conv3x3.apply(x, weight, bias, residual, negative_slope,
                             operands)
    return conv3x3_kernel(x, weight, bias, residual, negative_slope,
                          operands)
