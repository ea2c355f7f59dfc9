"""The work counts against torch's own FLOP counter over the plain
reference, and the counts' bound: counted work never exceeds what the
program launches at the cells' shapes, so no share can pass 100%."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

from harness import work  # noqa: E402
from reference import model as ref_model  # noqa: E402
from reference import protocol  # noqa: E402


def seeded_hq(seed=0):
    g = ref_model.Generator("hq")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in g.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return g.eval()


@pytest.mark.parametrize("length", [7, 13])
def test_video_flops_equal_flop_counter(length):
    """HQ at 108x60 (one attention window a frame), T = 7 (two windows)
    and 13 (three, with reference frames): the whole protocol's products,
    counted by FlopCounterMode, equal the analytic count."""
    g = seeded_hq()
    rng = np.random.default_rng(length)
    frames = rng.integers(0, 256, (length, 60, 108, 3), dtype=np.uint8)
    masks = np.zeros((length, 60, 108, 1), np.uint8)
    masks[:, 20:40, 30:70] = 1
    with FlopCounterMode(display=False) as fc:
        protocol.inpaint(g, ref_model.Ops(), frames, masks, frames, masks,
                         np.uint8, "cpu")
    want = work.video_work("hq", length, 60, 108, 4, 14,
                           keys="reference")["model_flops"]
    assert fc.get_total_flops() == want


def test_kernel_flops_equal_flop_counter():
    """K1 (one DCN over a frame) and K3 (one block's attention) alone."""
    g = seeded_hq()
    ops = ref_model.Ops()
    hq, wq, t = 15, 27, 4
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, hq, wq, 256), generator=gen)
    head = torch.randn((1, hq, wq, 432), generator=gen)
    f1, f2 = torch.randn((2, 1, hq, wq, 2), generator=gen)
    al = g.feat_prop_module.deform_align["forward_"]
    with FlopCounterMode(display=False) as fc:
        ref_model.deform_conv(ops, x, head, f1, f2, al.weight, al.bias)
    assert fc.get_total_flops() == work.dcn_flops(hq, wq)
    lh, lw = ref_model.token_grid((hq, wq))
    tok = torch.randn((1, t, lh, lw, 512), generator=gen)
    block = g.transformer[0]
    pooled = ref_model._pool(block, ops, tok)
    with FlopCounterMode(display=False) as fc:
        ref_model.window_attention(block.attn, ops, tok, pooled)
    attn = work.attention_flops(t, lh, lw, "reference")
    linears = 2 * t * lh * lw * 512 * (1536 + 512) + 2 * t * 512 * 1536
    assert fc.get_total_flops() == attn + linears


CELL_SHAPES = [("base", 240, 432, 2, 14), ("hq", 480, 854, 2, 14),
               ("base", 240, 432, 4, 4)]


@pytest.mark.parametrize("variant,h,w,esize,max_batch", CELL_SHAPES)
def test_counts_never_exceed_the_launched_work(variant, h, w, esize,
                                               max_batch):
    """For every length of the cells' span, the counted K1 and K3 work is
    at most what the program launches on its end-padded batches (every
    window at the batch's T_pad and n_local, K3 over the padded key
    table), and the dedup key count is at most the reference's."""
    hp, wp = work.padded(h, w)
    hq, wq = hp // 4, wp // 4
    lh, lw = ref_model.token_grid((hq, wq))
    smax = max(work.key_counts(lh, lw, "dedup"))
    nwin = len(work.key_counts(lh, lw, "dedup"))
    assert all(a <= b for a, b in zip(work.key_counts(lh, lw, "dedup"),
                                      work.key_counts(lh, lw, "reference")))
    for length in range(25, 105):
        got = work.video_work(variant, length, h, w, esize, max_batch)
        plan = protocol.windows(length)
        n_local = max(len(nb) for nb, _ in plan)
        t_pad = n_local + max(len(r) for _, r in plan)
        launched_k1 = len(plan) * 2 * (n_local - 1) * work.dcn_flops(hq, wq)
        nq, nk = t_pad * 45, t_pad * (45 + smax)
        launched_k3 = len(plan) * 8 * nwin * 4 * 4 * nq * nk * 128
        assert got["k1_flops"] <= launched_k1
        assert got["k3_flops"] <= launched_k3
        ref = work.video_work(variant, length, h, w, esize, max_batch,
                              keys="reference")
        assert got["model_flops"] <= ref["model_flops"]
