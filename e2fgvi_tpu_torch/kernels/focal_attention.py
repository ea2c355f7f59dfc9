"""K3 focal window attention: wrapper and plain form.

Counterpart of e2fgvi_tpu/kernels/fused_attention.py; the CUDA kernel is
csrc/focal_attention.cu. Same interface as the JAX kernel: the per-head
window partitions q/ko/vo, the gathered rolled + pooled keys, float32
per-key biases, and a (B*nWin, nq, heads*hd) output. The query and key
counts need no padding here; the kernel masks ragged tiles itself.

The wrapper takes the plain version for tensors on the CPU, and only then.
For CUDA tensors it launches the kernel or raises. The kernel is
forward-only. `LAUNCHES` counts its launches.
"""

import torch

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.kernels.deform import check_cuda_inputs

LAUNCHES = {"focal_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 128


def focal_attention_plain(q, ko, vo, k_gath, v_gath, bias_o, bias_g, b,
                          heads):
    """The JAX package's `_xla_reference` in float32 torch.

    q/ko/vo: (b*heads*nwin, nq|no, hd); k_gath/v_gath: (b*heads, t, nwin,
    s, hd); bias_o: (b, 1, no); bias_g: (b*nwin, 1, t*s).
    Returns (b*nwin, nq, heads*hd) in q's dtype."""
    bh, t, nwin, s, hd = k_gath.shape
    nq, no = q.shape[1], ko.shape[1]
    qf = q.float().reshape(b, heads, nwin, nq, hd)
    kow = ko.float().reshape(b, heads, nwin, no, hd)
    vow = vo.float().reshape(b, heads, nwin, no, hd)
    k = k_gath.float().reshape(b, heads, t, nwin, s, hd)
    k = k.permute(0, 1, 3, 2, 4, 5).reshape(b, heads, nwin, t * s, hd)
    v = v_gath.float().reshape(b, heads, t, nwin, s, hd)
    v = v.permute(0, 1, 3, 2, 4, 5).reshape(b, heads, nwin, t * s, hd)
    s1 = torch.einsum("bhwqd,bhwkd->bhwqk", qf, kow)
    s1 = s1 + bias_o.float().reshape(b, 1, 1, 1, no)
    s2 = torch.einsum("bhwqd,bhwkd->bhwqk", qf, k)
    s2 = s2 + bias_g.float().reshape(b, 1, nwin, 1, t * s)
    p = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    o = torch.einsum("bhwqk,bhwkd->bhwqd", p[..., :no], vow)
    o = o + torch.einsum("bhwqk,bhwkd->bhwqd", p[..., no:], v)
    return o.permute(0, 2, 3, 1, 4).reshape(b * nwin, nq, heads * hd).to(
        q.dtype)


def focal_attention(q, ko, vo, k_gath, v_gath, bias_o, bias_g, b, heads):
    """softmax over [own keys | gathered keys] with per-key bias, times v.

    Shapes as in focal_attention_plain; hd must be 128 on CUDA. q, k and v
    share one dtype (float32 or bfloat16); the biases are float32."""
    if q.device.type == "cpu":
        return focal_attention_plain(q, ko, vo, k_gath, v_gath, bias_o,
                                     bias_g, b, heads)
    q, ko, vo = q.contiguous(), ko.contiguous(), vo.contiguous()
    k_gath, v_gath = k_gath.contiguous(), v_gath.contiguous()
    bias_o = bias_o.float().contiguous()
    bias_g = bias_g.float().contiguous()
    check_cuda_inputs("focal_attention", q, ko, vo, k_gath, v_gath, bias_o,
                      bias_g)
    if q.dtype not in _DTYPES or any(
            t.dtype != q.dtype for t in (ko, vo, k_gath, v_gath)):
        raise ValueError("focal_attention: q/k/v must share one dtype, "
                         "float32 or bfloat16")
    bh, t, nwin, s, hd = k_gath.shape
    nq, no = q.shape[1], ko.shape[1]
    if hd != HEAD_DIM:
        raise ValueError(f"focal_attention: head dim {hd}, the kernel "
                         f"takes {HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in (q, ko, vo, k_gath, v_gath)):
        raise ValueError("focal_attention: q/k/v must be 16-byte aligned")
    if (bh != b * heads or q.shape != (b * heads * nwin, nq, hd)
            or ko.shape != (b * heads * nwin, no, hd)
            or vo.shape != ko.shape or v_gath.shape != k_gath.shape
            or bias_o.shape != (b, 1, no)
            or bias_g.shape != (b * nwin, 1, t * s)):
        raise ValueError("focal_attention: inconsistent shapes")
    out = torch.empty((b * nwin, nq, heads * hd), dtype=q.dtype,
                      device=q.device)
    err = build.library().e2fgvi_focal_attention(
        _DTYPES[q.dtype], q.data_ptr(), ko.data_ptr(), vo.data_ptr(),
        k_gath.data_ptr(), v_gath.data_ptr(), bias_o.data_ptr(),
        bias_g.data_ptr(), out.data_ptr(), b, heads, nwin, t, s, nq, no, hd,
        *build.stream_args(q))
    build.check(err, "focal_attention")
    LAUNCHES["focal_attention"] += 1
    return out
