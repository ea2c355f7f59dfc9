"""K3 focal window attention: wrapper and plain form.

Counterpart of e2fgvi_tpu/kernels/fused_attention.py; the CUDA kernel is
csrc/focal_attention.cu. Where the JAX kernel takes the window's own keys
and the gathered rolled + pooled keys as two panels, the port takes one
contiguous key panel per (b, head, window), own keys first (models/tfocal.py
builds it with one gather per k and v), and one float32 bias row per
(b, window) that joins the two panels' biases. The query and key counts need
no padding; the kernels mask ragged tiles themselves.

The wrapper takes the plain version for tensors on the CPU, and only then.
For CUDA tensors it launches the kernel or raises. Where grad mode is on
and q, k or v requires grad, it goes through FocalAttention: the kernel
runs forward, the backward recomputes the plain version (the JAX kernel's
_bwd recomputes through its XLA reference the same way). `LAUNCHES` counts
its launches.
"""

import torch
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.kernels.deform import (check_cuda_inputs,
                                             differentiable, plain_vjp)

LAUNCHES = {"focal_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 128
KEY_TILE = 128      # the bf16 kernel's key tile: the bias row's stride unit


def focal_attention_plain(q, k, v, bias, b, heads):
    """softmax(q k^T + bias) v per (b, head, window) in float32 torch.

    q: (b*heads*nwin, nq, hd); k, v: (b*heads*nwin, nk, hd); bias:
    (b*nwin, nk). Returns (b*nwin, nq, heads*hd) in q's dtype."""
    nq, hd = q.shape[1], q.shape[2]
    nk = k.shape[1]
    nwin = q.shape[0] // (b * heads)
    qf = q.float().reshape(b, heads, nwin, nq, hd)
    kf = k.float().reshape(b, heads, nwin, nk, hd)
    vf = v.float().reshape(b, heads, nwin, nk, hd)
    s = torch.einsum("bhwqd,bhwkd->bhwqk", qf, kf)
    s = s + bias.float().reshape(b, 1, nwin, 1, nk)
    o = torch.einsum("bhwqk,bhwkd->bhwqd", torch.softmax(s, dim=-1), vf)
    return o.permute(0, 2, 3, 1, 4).reshape(b * nwin, nq, heads * hd).to(
        q.dtype)


def padded_bias(bias):
    """The kernels' bias rows: (b*nwin, ld) float32, ld the key count
    rounded up to a whole key tile, -inf past the keys."""
    nk = bias.shape[1]
    ld = -(-nk // KEY_TILE) * KEY_TILE
    return F.pad(bias.float(), (0, ld - nk), value=float("-inf"))


class FocalAttention(torch.autograd.Function):
    """K3 with a gradient in q, k and v (the bias, made from the masks,
    takes none): forward launches the kernel on detached inputs; backward
    recomputes focal_attention_plain and returns its VJP."""

    @staticmethod
    def forward(ctx, q, k, v, bias, b, heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.static = (b, heads)
        return focal_attention_kernel(q.detach(), k.detach(), v.detach(),
                                      bias.detach(), b, heads)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(ctx, focal_attention_plain, grad, *ctx.static)


def focal_attention(q, k, v, bias, b, heads):
    """softmax over the key panel with per-key bias, times v.

    Shapes as in focal_attention_plain; hd must be 128 on CUDA. q, k and v
    share one dtype (float32 or bfloat16); the bias is float32. CPU tensors
    take the plain version; CUDA tensors the kernel, through FocalAttention
    where an input requires grad."""
    if q.device.type == "cpu":
        return focal_attention_plain(q, k, v, bias, b, heads)
    if differentiable(q, k, v, bias):
        return FocalAttention.apply(q, k, v, bias, b, heads)
    return focal_attention_kernel(q, k, v, bias, b, heads)


def focal_attention_kernel(q, k, v, bias, b, heads):
    """Launch K3 on CUDA tensors (shapes as in focal_attention_plain)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    panels, nq, hd = q.shape
    nk = k.shape[1]
    nwin = panels // (b * heads) if b * heads else 0
    if (nk == 0 or panels != b * heads * nwin or k.shape != (panels, nk, hd)
            or v.shape != k.shape or bias.shape != (b * nwin, nk)):
        raise ValueError("focal_attention: inconsistent shapes")
    bias = padded_bias(bias).contiguous()
    check_cuda_inputs("focal_attention", q, k, v, bias)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("focal_attention: q/k/v must share one dtype, "
                         "float32 or bfloat16")
    if hd != HEAD_DIM:
        raise ValueError(f"focal_attention: head dim {hd}, the kernel "
                         f"takes {HEAD_DIM}")
    # TMA reads from 16-byte addresses (both dtypes)
    if any(t.data_ptr() % 16 for t in (q, k, v, bias)):
        raise ValueError("focal_attention: q/k/v must be 16-byte aligned")
    out = torch.empty((b * nwin, nq, heads * hd), dtype=q.dtype,
                      device=q.device)
    err = build.library().e2fgvi_focal_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, heads, nwin, nq, nk,
        bias.shape[1], hd, *build.stream_args(q))
    build.check(err, "focal_attention")
    LAUNCHES["focal_attention"] += 1
    return out
