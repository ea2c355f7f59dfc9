"""Convolution, normalisation and activation wrappers on channel-last tensors.

Counterpart of e2fgvi_tpu/ops/convs.py. The port keeps the JAX package's
NHWC layout at its public functions; weights stay in the reference
checkpoint's layout (conv OIHW, Linear (out, in)). `conv2d` hands PyTorch
the NHWC tensor as a channels-last NCHW view, so cuDNN runs its native
NHWC kernels and the result comes back without a copy.
"""

import torch.nn.functional as F


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def conv2d(x, w, b=None, stride=1, padding=0, groups=1):
    """x: (N, H, W, Cin); w: (Cout, Cin/groups, kh, kw); -> (N, Ho, Wo, Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), _cast(b, x.dtype),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def leaky_relu(x, negative_slope=0.2):
    return F.leaky_relu(x, negative_slope)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis with float32 statistics."""
    out = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(),
                       beta.float(), eps)
    return out.to(x.dtype)


def linear(x, w, b=None):
    """x: (..., Cin); w: (Cout, Cin), the torch Linear layout."""
    return F.linear(x, w.to(x.dtype), _cast(b, x.dtype))


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x)
