"""C2 (RAFT's update-block convolutions): wrapper, operands and plain form.

The CUDA kernel is in csrc/raft_conv.cu (namespace raft_conv): C1's
implicit GEMM on 3xTF32 wgmma (kernels/conv.py) over the tap geometries
1x1, 3x3, 1x5 and 5x1, stride 1, "same" padding, for float32 channel-last
inputs that may be a channel range of a wider buffer, with the bias and one
of four epilogues: none, ReLU, the separable GRU's stacked z and r
(sigmoid; z to `z`, r * net to `out`) and its q (`out` = (1 - z) * net +
z * tanh(q)). Outputs may be channel ranges of a wider buffer too, so
models/raft.py keeps the GRU's [net, x] and [x, r * net] in one state
buffer instead of concatenating them. It has no TPU counterpart: the JAX
package has no RAFT.

`raft_conv` takes its plain version (conv_gemm, then the epilogue written
out) for tensors on the CPU, and only then. For CUDA tensors it launches
the kernel or raises. It is forward only (RAFT runs frozen, under serving)
and refuses inputs that require grad while grad mode is on. `LAUNCHES`
counts the kernel's launches.

The weight reordered and split for the kernel (conv_operands) is made once
a refine (models/raft.py update_operands) and passed in.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels import build, conv
from e2fgvi_tpu_torch.kernels.deform import differentiable

LAUNCHES = {"raft_conv": 0}

# the N-tiles the kernel is built with for each tap geometry (kh, kw)
BUILT = {(1, 1): (128, 144), (3, 3): (8, 64, 96, 128), (1, 5): (128,),
         (5, 1): (128,)}
MODES = {"none": 0, "relu": 1, "zr": 2, "gru": 3}


def conv_gemm(x, weight, bias, stride, padding):
    """A convolution as one GEMM: the (ky, kx, c) patches of the
    zero-padded channel-last x gathered into rows (a strided view, one
    copy), times the weight reordered to match. x (N, H, W, Cin); weight
    (Cout, Cin, kh, kw); padding (ph, pw). -> (N, Ho, Wo, Cout)."""
    n, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    ph, pw = padding
    ho = (h + 2 * ph - kh) // stride + 1
    wo = (w + 2 * pw - kw) // stride + 1
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    sn, sh, sw, sc = xp.stride()
    patches = xp.as_strided((n, ho, wo, kh, kw, cin),
                            (sn, sh * stride, sw * stride, sh, sw, sc))
    wm = weight.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    y = F.linear(patches.reshape(n * ho * wo, kh * kw * cin), wm, bias)
    return y.reshape(n, ho, wo, cout)


def raft_conv_plain(x, weight, bias, act="none", net=None, z=None):
    """Plain version of C2: conv_gemm (stride 1, padding (kh // 2,
    kw // 2)), then the epilogue: "none"; "relu"; "zr", the pair
    (sigmoid of the first half of the columns, sigmoid of the second half
    times net); "gru", (1 - z) * net + z * tanh(.). x (N, H, W, Cin),
    weight (Cout, Cin, kh, kw)."""
    kh, kw = weight.shape[2:]
    y = conv_gemm(x, weight, bias, 1, (kh // 2, kw // 2))
    if act == "relu":
        return F.relu(y)
    if act == "zr":
        half = y.shape[-1] // 2
        return torch.sigmoid(y[..., :half]), torch.sigmoid(y[..., half:]) * net
    if act == "gru":
        return (1 - z) * net + z * torch.tanh(y)
    return y


def n_tile(kh, kw, cout):
    """The N-tile C2 takes for Cout outputs at the tap geometry (kh, kw):
    of the widths built for it, the one that pads Cout least, the widest
    among equals. Raises ValueError for a geometry not built or an odd
    Cout (the epilogue stores column pairs)."""
    if (kh, kw) not in BUILT:
        raise ValueError(f"raft_conv takes taps {sorted(BUILT)}; got "
                         f"{kh}x{kw}")
    if cout <= 0 or cout % 2:
        raise ValueError(f"raft_conv takes an even Cout; got {cout}")
    return min(BUILT[(kh, kw)], key=lambda bn: (-(-cout // bn) * bn - cout,
                                                -bn))


class RaftConvOperands(NamedTuple):
    """One convolution as C2 takes it: the weight (Cout, Cin, kh, kw) and
    bias (Cout,) in float32, detached (the plain version's); the B operand
    (2, Cout_pad, kh * kw * Cin_pad), conv.conv_weight's split into tf32
    big and small parts with zero rows past Cout, and the bias to Cout_pad
    (the kernel's); the N-tile bn, Cout_pad = Cout rounded up to it."""
    weight: torch.Tensor
    bias: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    bn: int


def conv_operands(weight, bias) -> RaftConvOperands:
    """C2's operands of a weight (Cout, Cin, kh, kw) and bias (Cout,) or
    None: made once for every call that uses one weight. Raises ValueError
    for what the kernel does not take: a dtype other than float32, Cin not
    a multiple of 4, taps or Cout n_tile refuses."""
    weight = weight.detach()
    if weight.dtype != torch.float32 or weight.dim() != 4:
        raise ValueError(f"raft_conv takes a float32 weight (Cout, Cin, kh, "
                         f"kw); got {weight.dtype} {tuple(weight.shape)}")
    cout, cin, kh, kw = weight.shape
    if cin % 4:
        raise ValueError(f"raft_conv takes Cin a multiple of 4; got {cin}")
    bn = n_tile(kh, kw, cout)
    b32 = (weight.new_zeros(cout) if bias is None
           else bias.detach().float())
    pad = -(-cout // bn) * bn
    wp = weight.new_zeros((pad, cin, kh, kw))
    wp[:cout] = weight
    bp = weight.new_zeros(pad)
    bp[:cout] = b32
    wk, bk = conv.conv_operands(wp, bp)
    return RaftConvOperands(weight, b32, wk, bk, bn)


def pitch(t, name, multiple):
    """The pixel pitch (elements) of a channel-last (N, H, W, C) float32
    view whose pixels lie evenly spaced, as a channel range of a wider
    contiguous buffer does; ValueError otherwise, or where it is no
    multiple of `multiple`."""
    if t.dtype != torch.float32 or t.dim() != 4:
        raise ValueError(f"raft_conv: {name} must be a float32 (N, H, W, C) "
                         f"tensor; got {t.dtype} {tuple(t.shape)}")
    n, h, w, c = t.shape
    ld = t.stride(2)
    dense = t.stride(3) == 1 and ld >= c and all(
        t.shape[d] == 1 or t.stride(d) == s
        for d, s in ((0, h * w * ld), (1, w * ld)))
    if not dense or ld % multiple:
        raise ValueError(f"raft_conv: {name} must be channel-last with "
                         f"evenly spaced pixels at a pitch that is a "
                         f"multiple of {multiple}; got strides {t.stride()}")
    return ld


def check_inputs(x, ops, act, out=None, net=None, z=None):
    """Raise ValueError unless C2 takes these: a float32 x (N, H, W, Cin)
    at a pixel pitch that is a multiple of 4 (16-byte TMA rows), Cin the
    weight's; out (and for "zr" and "gru" net and z) of the output's shape
    at even pitches, the output Cout wide ("zr": Cout / 2); RuntimeError
    where grad mode is on and an input requires grad."""
    if act not in MODES:
        raise ValueError(f"raft_conv: act must be one of {sorted(MODES)}; "
                         f"got {act!r}")
    pitch(x, "x", 4)
    cout, cin = ops.weight.shape[:2]
    if x.shape[-1] != cin:
        raise ValueError(f"raft_conv: x has {x.shape[-1]} channels, the "
                         f"weight {cin}")
    shape = (*x.shape[:3], cout // 2 if act == "zr" else cout)
    need = {"out": out}
    if act in ("zr", "gru"):
        if net is None or z is None:
            raise ValueError(f"raft_conv: act {act!r} needs net and z")
        need.update(net=net, z=z)
    for name, t in need.items():
        if t is not None:
            pitch(t, name, 2)
            if tuple(t.shape) != shape:
                raise ValueError(f"raft_conv: {name} must be {shape}; got "
                                 f"{tuple(t.shape)}")
    if differentiable(x, net, z):
        raise RuntimeError("raft_conv is forward only (RAFT runs frozen): "
                           "call it under torch.no_grad() or "
                           "torch.inference_mode()")


def raft_conv_kernel(x, ops, act="none", out=None, net=None, z=None):
    """Launch C2 on CUDA tensors (check_inputs' contract, x 16-byte and
    out, net, z 8-byte aligned): returns out, a new tensor where None."""
    check_inputs(x, ops, act, out, net, z)
    n, h, w, cin = x.shape
    cout, _, kh, kw = ops.weight.shape
    width = cout // 2 if act == "zr" else cout
    if out is None:
        out = torch.empty((n, h, w, width), dtype=torch.float32,
                          device=x.device)
    for t in (out, net, z, ops.wk, ops.bk):
        if t is not None and t.device != x.device:
            raise ValueError(f"raft_conv: every tensor must be on x's "
                             f"device {x.device}; got {t.device}")
    if not x.is_cuda:
        raise ValueError(f"raft_conv's kernel takes CUDA tensors; got "
                         f"{x.device}")
    if x.data_ptr() % 16 or any(t.data_ptr() % 8 for t in (out, net, z)
                                if t is not None):
        raise ValueError("raft_conv: x must be 16-byte and out, net, z "
                         "8-byte aligned")

    def at(t):
        """(pointer, pixel pitch) of a tensor check_inputs passed, or
        (0, 0) for none."""
        return (0, 0) if t is None else (t.data_ptr(), t.stride(2))

    err = build.library().e2fgvi_raft_conv(
        *at(x), ops.wk.data_ptr(), ops.bk.data_ptr(), *at(out), *at(z),
        *at(net),
        n, h, w, cin, cout, kh, kw, ops.bn, MODES[act],
        width if act == "zr" else 0, *build.stream_args(x))
    build.check(err, "raft_conv")
    LAUNCHES["raft_conv"] += 1
    return out


def raft_conv(x, ops, act="none", out=None, net=None, z=None):
    """A float32 convolution of RAFT's update block (stride 1, "same"
    padding) with its bias and epilogue `act`: C2.

    x (N, H, W, Cin), channel-last at any pixel pitch (a channel range of
    a wider buffer); ops: conv_operands(weight, bias); act "none", "relu",
    "zr" (ops holds z's and r's weights stacked: sigmoid of the first half
    of the columns to z, sigmoid of the second half times net to out) or
    "gru" (out = (1 - z) * net + z * tanh(.); out may be net); out, where
    given, a view the result is written into (else a new tensor). Returns
    out. Inputs outside check_inputs' contract raise on every device. CPU
    tensors take raft_conv_plain; CUDA tensors the kernel."""
    check_inputs(x, ops, act, out, net, z)
    if not x.is_cpu:
        return raft_conv_kernel(x, ops, act, out, net, z)
    return plain_call(x, ops, act, out, net, z)


def plain_call(x, ops, act="none", out=None, net=None, z=None):
    """raft_conv's call on its plain version, on any device: the CPU's
    path, and on the card the conv_gemm path C2 is held to."""
    y = raft_conv_plain(x, ops.weight, ops.bias, act, net, z)
    if act == "zr":
        zt, y = y
        z.copy_(zt)
    return y if out is None else out.copy_(y)
