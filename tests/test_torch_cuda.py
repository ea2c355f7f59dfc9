"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests skip where CUDA is absent.
On a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

(chip_smoke.py runs the same checks at serving shapes.)
"""

import numpy as np
import pytest
import torch

from e2fgvi_tpu_torch.kernels import deform
from e2fgvi_tpu_torch.kernels import focal_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from e2fgvi_tpu_torch.utils import env
    env.setup()
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, std=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * std


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_im2col_matches_plain(gen, dtype):
    n, h, w, cin, g = 2, 9, 13, 64, 4
    x = _randn(gen, n, h, w, cin).to(dtype)
    head = _randn(gen, n, h, w, 27 * g).to(dtype)
    f1, f2 = _randn(gen, n, h, w, 2, std=4), _randn(gen, n, h, w, 2, std=4)
    wt = _randn(gen, 16, cin, 3, 3, std=0.05).to(dtype)
    b = _randn(gen, 16).to(dtype)
    before = deform.LAUNCHES["deform_im2col"]
    got = deform.modulated_deform_conv2d_head(x, head, f1, f2, wt, b)
    assert deform.LAUNCHES["deform_im2col"] == before + 1
    want = deform.deform_conv_head_plain(x.float(), head.float(), f1, f2,
                                         wt.float(), b.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert (got.float() - want).abs().max() / want.abs().max() < 2e-2


@pytest.mark.parametrize("c", [2, 24, 128])
def test_flow_warp_matches_plain(gen, c):
    x = _randn(gen, 3, 11, 17, c)
    flow = _randn(gen, 3, 11, 17, 2, std=5)
    torch.testing.assert_close(deform.flow_warp(x, flow),
                               deform.flow_warp_plain(x, flow),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_focal_attention_matches_plain(gen, dtype):
    b, heads, nwin, t, s, nq, hd = 2, 2, 3, 3, 37, 70, 128
    q = _randn(gen, b * heads * nwin, nq, hd, std=hd ** -0.5).to(dtype)
    ko, vo = (_randn(gen, b * heads * nwin, nq, hd).to(dtype)
              for _ in range(2))
    kg, vg = (_randn(gen, b * heads, t, nwin, s, hd).to(dtype)
              for _ in range(2))
    bias_o = torch.zeros((b, 1, nq), device="cuda")
    bias_o[1, :, -20:] = -1e9
    bias_g = torch.zeros((b * nwin, 1, t * s), device="cuda")
    bias_g[:, :, 5:9] = -100.0
    bias_g[:, :, -s:] = -1e9
    got = fa.focal_attention(q, ko, vo, kg, vg, bias_o, bias_g, b, heads)
    want = fa.focal_attention_plain(q.float(), ko.float(), vo.float(),
                                    kg.float(), vg.float(), bias_o, bias_g,
                                    b, heads)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert (got.float() - want).abs().max() / want.abs().max() < 5e-2


def test_kernels_refuse_grad(gen):
    x = _randn(gen, 1, 4, 5, 8).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        deform.flow_warp(x, torch.zeros((1, 4, 5, 2), device="cuda"))
    assert np.isfinite(deform.flow_warp(
        x.detach(), torch.zeros((1, 4, 5, 2), device="cuda")).cpu()).all()
