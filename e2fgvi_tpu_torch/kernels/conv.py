"""C, the port's float32 convolution kernel: operands, launch, plain form.

The CUDA kernel is in csrc/conv.cu (namespace conv_tf32): an implicit GEMM
on 3xTF32 wgmma for float32 channel-last inputs, stride 1, "same" padding,
over the tap geometries 1x1, 3x3, 1x5 and 5x1, with the bias and one
epilogue: none, ReLU, LeakyReLU, the separable GRU's stacked z and r
(sigmoid; z to `z`, r * net to `out`) or its q (`out` = (1 - z) * net +
z * tanh(q)); after the first three, an optional residual add. Inputs and
outputs may be channel ranges of a wider buffer (any pixel pitch). It has
no TPU counterpart: the JAX package left these convolutions to XLA.

Three entry points share one launch path and one plain form; they differ
in autograd and in the count of `LAUNCHES` they add to:

* `conv3x3` (feat_prop's 3x3 convolutions, with LeakyReLU and the
  residual): CPU tensors take the plain form, CUDA tensors the kernel,
  through the autograd Function Conv3x3 where grad mode is on and an input
  requires grad. Its backward is the plain form's vector-Jacobian product,
  as K1's and K3's are (kernels/deform.py plain_vjp).
* `raft_conv` (RAFT's update block): forward only (RAFT runs frozen),
  writing into `out` where given.
* `encoder_conv` (the E2FGVI encoder's stride-1 3x3 convolutions, with
  LeakyReLU): forward only; a grouped convolution is one launch a group,
  on channel ranges of one input and one output.

The weight reordered and split for the kernel (conv_operands) is made once
by a caller that runs one weight many times (models/feat_prop.py, once a
propagation; models/raft.py, once a refine; models/e2fgvi.py, once an
encoder call) and passed in.
"""

import array
from typing import NamedTuple

import torch
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.kernels.deform import (_aligned, differentiable,
                                             plain_vjp, split_tf32)
from e2fgvi_tpu_torch.ops.convs import conv2d, leaky_relu

LAUNCHES = {"conv3x3": 0, "raft_conv": 0, "encoder": 0}

CHUNK = 32                  # K chunk: 32 channels of one tap
# the N-tiles the kernel is built with for each tap geometry (kh, kw)
BUILT = {(1, 1): (128, 144), (3, 3): (8, 32, 64, 96, 128, 144),
         (1, 5): (128,), (5, 1): (128,)}
ACTS = {"none": 0, "relu": 1, "zr": 2, "gru": 3, "leaky": 4}
# the epilogues a residual may follow
RESIDUAL_ACTS = ("none", "relu", "leaky")


def conv_plain(x, weight, bias=None, residual=None, act="none",
               negative_slope=None, net=None, z=None):
    """Plain version of C: ops.convs.conv2d (stride 1, padding (kh // 2,
    kw // 2)), then epilogue(). x (N, H, W, Cin) at any pixel pitch,
    weight (Cout, Cin, kh, kw); in x's dtype."""
    kh, kw = weight.shape[2:]
    return epilogue(conv2d(x, weight, bias, padding=(kh // 2, kw // 2)),
                    residual, act, negative_slope, net, z)


def epilogue(y, residual=None, act="none", negative_slope=None, net=None,
             z=None):
    """C's epilogue on a convolution's output y (its bias added): "none";
    "relu"; "leaky", LeakyReLU(negative_slope); "zr", the pair (sigmoid of
    the first half of the columns, sigmoid of the second half times net);
    "gru", (1 - z) * net + z * tanh(y); then residual + the result where
    given."""
    if act == "relu":
        y = F.relu(y)
    elif act == "leaky":
        y = leaky_relu(y, negative_slope)
    elif act == "zr":
        half = y.shape[-1] // 2
        return torch.sigmoid(y[..., :half]), torch.sigmoid(y[..., half:]) * net
    elif act == "gru":
        return (1 - z) * net + z * torch.tanh(y)
    return y if residual is None else residual + y


def n_tile(kh, kw, cout):
    """The N-tile C takes for Cout outputs at the tap geometry (kh, kw): of
    the widths built for it, the one that pads Cout least, the widest among
    equals. Raises ValueError for a geometry not built or an odd Cout (the
    epilogue stores column pairs)."""
    if (kh, kw) not in BUILT:
        raise ValueError(f"conv takes taps {sorted(BUILT)}; got {kh}x{kw}")
    if cout <= 0 or cout % 2:
        raise ValueError(f"conv takes an even Cout; got {cout}")
    return min(BUILT[(kh, kw)], key=lambda bn: (-(-cout // bn) * bn - cout,
                                                -bn))


def check_weight(weight):
    """Raise ValueError unless C takes this weight: float32 (Cout, Cin, kh,
    kw), Cin a multiple of 4 (the input's rows are 16-byte multiples for
    TMA), taps and Cout that n_tile takes."""
    if weight.dtype != torch.float32 or weight.dim() != 4:
        raise ValueError(f"conv takes a float32 weight (Cout, Cin, kh, kw); "
                         f"got {weight.dtype} {tuple(weight.shape)}")
    cout, cin, kh, kw = weight.shape
    if cin % 4:
        raise ValueError(f"conv takes Cin a multiple of 4; got {cin}")
    n_tile(kh, kw, cout)


def conv_weight(weight):
    """The weight (Cout, Cin, kh, kw) as C's B operand in float32: (Cout,
    kh * kw * Cin_pad), K-major, Cin_pad = Cin rounded up to 32 with zero
    channels; chunk q = c * kh * kw + tap (tap = kw ky + kx) holds channels
    32c .. 32c + 31 of that tap, column 8kk + j of the chunk channel
    8 (j % 4) + 2kk + j // 4: thread t of a quad hands the wgmma's k-step kk
    its channels 8t + 2kk (k-column t) and 8t + 2kk + 1 (k-column t + 4)."""
    cout, cin, kh, kw = weight.shape
    chunks = -(-cin // CHUNK)
    w = weight.new_zeros((cout, chunks * CHUNK, kh, kw), dtype=torch.float32)
    w[:, :cin] = weight.float()
    # channel (t, kk, h) = 8t + 2kk + h to column (kk, h, t), as a view:
    # no index tensor to upload
    w = w.reshape(cout, chunks, 4, 4, 2, kh * kw).permute(0, 1, 5, 3, 4, 2)
    return w.reshape(cout, chunks * kh * kw * CHUNK).contiguous()


class Operands(NamedTuple):
    """One convolution as C takes it: the weight (Cout, Cin, kh, kw) and
    bias (Cout,) in float32, detached (the plain form's); the B operand
    (2, Cout_pad, kh * kw * Cin_pad), conv_weight's split into tf32 big and
    small parts (kernels.deform.split_tf32) with zero rows past Cout, and
    the bias to Cout_pad (the kernel's); the N-tile bn, Cout_pad = Cout
    rounded up to it."""
    weight: torch.Tensor
    bias: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    bn: int


def conv_operands(weight, bias) -> Operands:
    """C's operands of a weight (Cout, Cin, kh, kw) and bias (Cout,) or None
    (zeros): made once for every call that uses one weight. Raises
    ValueError where check_weight does."""
    weight = weight.detach()
    check_weight(weight)
    cout, _, kh, kw = weight.shape
    bn = n_tile(kh, kw, cout)
    pad = -(-cout // bn) * bn - cout
    b32 = (weight.new_zeros(cout) if bias is None
           else bias.detach().float())
    wk = torch.stack(split_tf32(conv_weight(
        F.pad(weight, (0, 0, 0, 0, 0, 0, 0, pad))))).contiguous()
    return Operands(weight, b32, wk, F.pad(b32, (0, pad)), bn)


def group_operands(weight, bias, groups):
    """C's operands of each group of a convolution in `groups` groups
    (weight (Cout, Cin / groups, kh, kw), bias (Cout,)): group g's are
    conv_operands of weight rows and bias entries g Cout_g .. (g + 1)
    Cout_g, Cout_g = Cout / groups. Raises ValueError where check_weight
    does for a group's weight."""
    cg = weight.shape[0] // groups
    return [conv_operands(weight[g * cg:(g + 1) * cg],
                          bias[g * cg:(g + 1) * cg]) for g in range(groups)]


def pitch(t, name, multiple):
    """The pixel pitch (elements) of a channel-last (N, H, W, C) float32
    view whose pixels lie evenly spaced, as a channel range of a wider
    contiguous buffer does; ValueError otherwise, or where it is no
    multiple of `multiple`."""
    if t.dtype != torch.float32 or t.dim() != 4:
        raise ValueError(f"conv: {name} must be a float32 (N, H, W, C) "
                         f"tensor; got {t.dtype} {tuple(t.shape)}")
    if t.is_contiguous():            # the common case, read at once
        ld = t.shape[3]
    else:
        n, h, w, c = t.shape
        ld = t.stride(2)
        if not (t.stride(3) == 1 and ld >= c and all(
                t.shape[d] == 1 or t.stride(d) == s
                for d, s in ((0, h * w * ld), (1, w * ld)))):
            ld = -1
    if ld < 0 or ld % multiple:
        raise ValueError(f"conv: {name} must be channel-last with evenly "
                         f"spaced pixels at a pitch that is a multiple of "
                         f"{multiple}; got strides {t.stride()}")
    return ld


def check_inputs(x, weight, act="none", out=None, net=None, z=None,
                 residual=None, negative_slope=None):
    """Raise ValueError unless C takes these with a weight of `weight`'s
    shape: a float32 x (N, H, W, Cin) at a pixel pitch that is a multiple
    of 4 (16-byte TMA rows), Cin the weight's; out, the residual (after
    "none", "relu" and "leaky" only, and with a Cout that fills its
    N-tiles: the kernel's residual loop has no column guard) and for "zr"
    and "gru" net and z of
    the output's shape at even pitches, the output Cout wide ("zr":
    Cout / 2); a slope for "leaky" and none elsewhere. A contiguous x, out
    and residual are the common case."""
    if act not in ACTS:
        raise ValueError(f"conv: act must be one of {sorted(ACTS)}; got "
                         f"{act!r}")
    if (act == "leaky") != (negative_slope is not None):
        raise ValueError("conv: act 'leaky' takes a negative_slope, and "
                         "only it does")
    pitch(x, "x", 4)
    cout, cin = weight.shape[:2]
    if x.shape[3] != cin:
        raise ValueError(f"conv: x has {x.shape[3]} channels, the weight "
                         f"{cin}")
    if residual is not None and act not in RESIDUAL_ACTS:
        raise ValueError(f"conv: a residual follows {RESIDUAL_ACTS} only; "
                         f"got {act!r}")
    if residual is not None and cout % n_tile(*weight.shape[2:], cout):
        raise ValueError(f"conv: a residual takes whole N-tiles (Cout a "
                         f"multiple of {n_tile(*weight.shape[2:], cout)}); "
                         f"got Cout {cout}")
    if act in ("zr", "gru") and (net is None or z is None):
        raise ValueError(f"conv: act {act!r} needs net and z")
    shape = None
    for name, t in (("out", out), ("residual", residual), ("net", net),
                    ("z", z)):
        if t is not None:
            pitch(t, name, 2)
            shape = shape or (*x.shape[:3], cout // 2 if act == "zr"
                              else cout)
            if t.shape != shape:
                raise ValueError(f"conv: {name} must be {shape}; got "
                                 f"{tuple(t.shape)}")


def launch(x, ops, act="none", out=None, net=None, z=None, residual=None,
           negative_slope=None, counter="raft_conv"):
    """Launch C on CUDA tensors (check_inputs' contract; out, net and z
    8-byte aligned, a misaligned x or residual is copied); ops:
    conv_operands(weight, bias). Returns out, a new tensor where None, and
    adds one to LAUNCHES[counter]. Refuses an input that requires grad: a
    launch is forward-only."""
    check_inputs(x, ops.weight, act, out, net, z, residual, negative_slope)
    dev = x.get_device()                 # -1 on the CPU
    if dev < 0:
        raise ValueError(f"conv's kernel takes CUDA tensors; got {x.device}")
    n, h, w, cin = x.shape
    cout, _, kh, kw = ops.weight.shape
    if out is None:
        out = torch.empty((n, h, w, cout // 2 if act == "zr" else cout),
                          dtype=torch.float32, device=x.device)
    # TMA takes x 16-byte aligned, the float2 loads and stores the others
    # 8-byte: a misaligned x or residual is copied, an output refused
    x = _aligned(x, 16)
    if residual is not None:
        residual = _aligned(residual, 8)
    if any(t is not None and t.data_ptr() % 8 for t in (out, net, z)):
        raise ValueError("conv: out, net and z must be 8-byte aligned")
    for t in (x, out, z, net, residual, ops.wk, ops.bk):
        if t is None:
            continue
        if t.requires_grad:
            raise RuntimeError(
                "conv: a kernel launch is forward-only; conv3x3 takes inputs "
                "that require grad through its autograd Function "
                "(kernels.conv.Conv3x3), raft_conv runs under "
                "torch.no_grad()")
        if t.get_device() != dev:
            raise ValueError(f"conv: every tensor must be on x's device "
                             f"{x.device}; got {t.device}")
    # csrc/conv.cu LaunchArgs in one int64 array: (pointer, pixel pitch) of
    # x, the operands' pointers, (pointer, pixel pitch) of out, z, net and
    # the residual ((0, 0) for none), the sizes and the mode
    args = array.array("q", (x.data_ptr(), x.stride(2), ops.wk.data_ptr(),
                             ops.bk.data_ptr()))
    for t in (out, z, net, residual):
        args.extend((0, 0) if t is None else (t.data_ptr(), t.stride(2)))
    args.extend((n, h, w, cin, cout, kh, kw, ops.bn, ACTS[act]))
    err = build.library().e2fgvi_conv(
        args.buffer_info()[0],
        1.0 if negative_slope is None else negative_slope,
        *build.stream_args(x))
    build.check(err, counter)
    LAUNCHES[counter] += 1
    return out


class Conv3x3(torch.autograd.Function):
    """conv3x3 with a gradient: forward launches the kernel on detached
    inputs; backward recomputes conv_plain and returns its VJP in x, the
    weight, the bias and the residual. `operands` is made from the live
    weight by the caller on every forward pass."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, act, negative_slope,
                operands):
        ctx.save_for_backward(x, weight, bias, residual)
        ctx.static = (act, negative_slope)
        return launch(x.detach(), operands, act,
                      residual=None if residual is None else residual.detach(),
                      negative_slope=negative_slope, counter="conv3x3")

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(ctx, conv_plain, grad, *ctx.static)


def conv3x3(x, weight, bias=None, stride=1, padding=1, negative_slope=None,
            residual=None, operands=None):
    """A float32 3x3 convolution (NHWC, stride 1, padding 1) with its bias,
    then LeakyReLU(negative_slope) where given, then residual + the result
    where given: feat_prop's entry point to C.

    x (N, H, W, Cin); weight (Cout, Cin, 3, 3); bias (Cout,) or None;
    residual (N, H, W, Cout) or None; operands: conv_operands(weight,
    bias), made here when None (operands of another weight's shape
    raise). Inputs outside check_weight's and check_inputs' contracts
    raise ValueError on every device. CPU tensors take conv_plain; CUDA
    tensors the kernel, through Conv3x3 where an input requires grad.
    Counts LAUNCHES["conv3x3"]."""
    if weight.shape[2:] != (3, 3) or stride != 1 or padding != 1:
        raise ValueError(f"conv3x3 takes a 3x3 kernel at stride 1 and "
                         f"padding 1; got {tuple(weight.shape)}, stride "
                         f"{stride}, padding {padding}")
    act = "none" if negative_slope is None else "leaky"
    if x.is_cpu:
        check_weight(weight)
        check_inputs(x, weight, act, residual=residual,
                     negative_slope=negative_slope)
        return conv_plain(x, weight, bias, residual, act, negative_slope)
    if operands is None:
        operands = conv_operands(weight, bias)       # checks the weight
    elif operands.weight.shape != weight.shape:
        raise ValueError("conv3x3: operands do not match the weight")
    if differentiable(x, weight, bias, residual):
        return Conv3x3.apply(x, weight, bias, residual, act, negative_slope,
                             operands)
    return launch(x, operands, act, residual=residual,
                  negative_slope=negative_slope, counter="conv3x3")


def raft_conv(x, ops, act="none", out=None, net=None, z=None):
    """A float32 convolution of RAFT's update block (stride 1, "same"
    padding) with its bias and epilogue `act`: RAFT's entry point to C.

    x (N, H, W, Cin), channel-last at any pixel pitch (a channel range of
    a wider buffer); ops: conv_operands(weight, bias); act "none", "relu",
    "zr" (ops holds z's and r's weights stacked: sigmoid of the first half
    of the columns to z, sigmoid of the second half times net to out) or
    "gru" (out = (1 - z) * net + z * tanh(.); out may be net); out, where
    given, a view the result is written into (else a new tensor). Returns
    out. Inputs outside check_inputs' contract raise on every device, and
    so does an input that requires grad under grad mode. CPU tensors take
    plain_call; CUDA tensors the kernel. Counts LAUNCHES["raft_conv"]."""
    if differentiable(x, net, z):
        raise RuntimeError("raft_conv is forward only (RAFT runs frozen): "
                           "call it under torch.no_grad() or "
                           "torch.inference_mode()")
    if not x.is_cpu:
        return launch(x, ops, act, out, net, z)
    check_inputs(x, ops.weight, act, out, net, z)
    return plain_call(x, ops, act, out, net, z)


def encoder_conv(x, ops, negative_slope):
    """A float32 3x3 convolution of the E2FGVI encoder (stride 1, padding
    1) with its bias, then LeakyReLU(negative_slope): the encoder's entry
    point to C. ops: group_operands(weight, bias, groups), one Operands a
    group (one for a dense convolution). Group g is one launch that reads
    channels g Cin_g .. (g + 1) Cin_g of x and writes channels g Cout_g ..
    (g + 1) Cout_g of one output, both as views at their buffer's pixel
    pitch: nothing is split, copied or concatenated.

    x (N, H, W, groups Cin_g), channel-last with evenly spaced pixels
    (cuDNN's stride-2 layers hand over contiguous maps). Returns (N, H, W,
    groups Cout_g), contiguous. Inputs outside check_inputs' contract
    raise on every device. CUDA tensors launch the kernel, forward only
    (counts LAUNCHES["encoder"]); CPU tensors take plain_call, group by
    group."""
    cin, cout = ops[0].weight.shape[1], ops[0].weight.shape[0]
    out = x.new_empty((*x.shape[:3], cout * len(ops)))
    for g, o in enumerate(ops):
        xg = x[..., g * cin:(g + 1) * cin]
        og = out[..., g * cout:(g + 1) * cout]
        if x.is_cuda:
            launch(xg, o, "leaky", out=og, negative_slope=negative_slope,
                   counter="encoder")
        else:
            check_inputs(xg, o.weight, "leaky", og,
                         negative_slope=negative_slope)
            plain_call(xg, o, "leaky", og, negative_slope=negative_slope)
    return out


def plain_call(x, ops, act="none", out=None, net=None, z=None,
               negative_slope=None):
    """raft_conv's and encoder_conv's call on the plain form, on any
    device: the CPU's path. x goes in as a contiguous NCHW copy: the CPU's
    channels-last convolution lands 3-6x farther from float64 than the
    NCHW one at RAFT's widths, and the iterations carry the error; and a
    channel range of a wider buffer gives the bits of the same channels
    copied out."""
    xc = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    y = conv_plain(xc, ops.weight, ops.bias, act=act,
                   negative_slope=negative_slope, net=net, z=z)
    if act == "zr":
        zt, y = y
        z.copy_(zt)
    return y.contiguous() if out is None else out.copy_(y)
