"""ProPainter on the port (models/raft.py, models/propainter.py, the
ProPainter protocol of data/pipeline.py) against the benchmark's plain
reference (perfbench/reference/propainter.py), on the CPU at small sizes
with seeded weights (perfbench/harness/weights_propainter.py): RAFT's
flows, the consistency check and the image propagation, the feature
propagation, one sparse attention layer with flagged and unflagged
windows, and the whole serving call. Both sides run in float32 here."""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness.weights_propainter import make_state_dicts  # noqa: E402
from reference import propainter as ref  # noqa: E402

from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter  # noqa
from e2fgvi_tpu_torch.models import propainter, raft  # noqa: E402

SEED = 9876543210123
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    torch.set_num_threads(2)
    sds = make_state_dicts(SEED, CPU)
    port_g, port_r = propainter.Generator(), raft.RAFT()
    ref_g, ref_r = ref.Generator(), ref.RAFT()
    for m, k in ((port_g, "generator"), (ref_g, "generator"),
                 (port_r, "raft"), (ref_r, "raft")):
        m.load_state_dict(sds[k], strict=True)
        m.eval()
    return port_g, port_r, ref_g, ref_r


def _video(t=7, h=128, w=128, seed=0):
    """Smooth uint8 frames and a moving rectangle mask."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand((t, 3, h // 8, w // 8), generator=g)
    fr = F.interpolate(low, size=(h, w), mode="bilinear") * 255
    fr = fr.permute(0, 2, 3, 1).to(torch.uint8).numpy()
    mk = np.zeros((t, h, w, 1), np.uint8)
    for i in range(t):
        mk[i, 30 + 2 * i: 70 + 2 * i, 20 + 3 * i: 60 + 3 * i] = 1
    return fr, mk


def _unit(fr):
    return torch.from_numpy(fr).float() / 255.0 * 2.0 - 1.0


def _nc(x):
    """Channel-last (..., H, W, C) to the reference's (..., C, H, W)."""
    return x.movedim(-1, -3).contiguous()


def _eighths(shape, scale, seed):
    """Random flows on a 1/8-pixel grid: bilinear weights are exact there,
    so both warps (pixel positions, normalized grids) read alike."""
    g = torch.Generator().manual_seed(seed)
    return torch.round(torch.randn(shape, generator=g) * scale * 8) / 8


@torch.no_grad()
def test_raft_flows_match_reference(weights):
    """video_flows (each frame's encoders once, fields refined together)
    against RAFT's per-pair forward, both directions, 3 iterations."""
    _, port_r, _, ref_r = weights
    fr, _ = _video(5)
    f = _unit(fr)
    ff, fb = raft.video_flows(port_r, f, iters=3, chunk=4)
    wf, wb = ref.video_flows(ref_r, _nc(f), iters=3)
    assert ff.shape == (4, 128, 128, 2)
    scale = float(wf.abs().mean())
    assert scale > 0.1
    for got, want in ((ff, wf), (fb, wb)):
        assert (got - want.permute(0, 2, 3, 1)).abs().max() < 1e-4


@torch.no_grad()
def test_fb_check_and_image_propagation_match_reference():
    """fbConsistencyCheck, then the non-learned propagation with nearest
    warps: the updated masks exactly, the frames tightly."""
    t, h, w = 6, 24, 40
    shift = torch.tensor([1.5, -0.75])      # a pan, and noise around it
    flows_f = shift + _eighths((t - 1, h, w, 2), 0.6, 1)
    flows_b = -shift + _eighths((t - 1, h, w, 2), 0.6, 2)
    got = propainter.fb_check(flows_f, flows_b)
    want = ref.fb_check(_nc(flows_f), _nc(flows_b))
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    assert 0.2 < float(got.mean()) < 0.95
    frames = torch.rand((t, h, w, 3)) * 2 - 1
    masks = torch.zeros((t, h, w, 1))
    for i in range(t):
        masks[i, 5 + i: 15 + i, 8 + 2 * i: 22 + 2 * i] = 1
    masked = frames * (1 - masks)
    pf, pm = propainter.image_propagation(masked, flows_f, flows_b, masks)
    wf, wm = ref.image_propagation(_nc(masked), (_nc(flows_f),
                                                  _nc(flows_b)), _nc(masks))
    assert torch.equal(pm, wm.permute(0, 2, 3, 1))
    assert (pf - wf.permute(0, 2, 3, 1)).abs().max() < 1e-6
    assert 0 < float(pm.sum()) < float(masks.sum())


def test_subvideo_spans_match_reference():
    for t in (7, 80, 81, 104, 200):
        assert propainter.subvideo_spans(t) == ref.subvideos(t)


@torch.no_grad()
def test_feature_propagation_matches_reference(weights):
    """The first-order propagation (K1's plain version at 16 groups of 8
    channels, residual 3) and the fuse, against the reference's literal
    loop with torchvision's DCN semantics, on 4 frames; and with an
    end-padded second batch element, whose backward pass starts afresh
    at its last real frame."""
    port_g, _, ref_g, _ = weights
    torch.manual_seed(0)
    t, h, w = 4, 16, 24
    x = torch.randn(2, t, h, w, 128)
    ff = torch.randn(2, t - 1, h, w, 2) * 1.5
    fb = -ff + torch.randn(2, t - 1, h, w, 2) * 0.3
    m = (torch.rand(2, t, h, w, 2) > 0.7).float()
    got = propainter.feature_propagation(port_g.feat_prop_module, x, ff, fb,
                                         m)
    want, _ = ref.propagation(ref.Ops(), ref_g.feat_prop_module, _nc(x),
                              _nc(ff), _nc(fb), _nc(m))
    want = want.permute(0, 1, 3, 4, 2)
    assert (got - want).abs().max() < 1e-3 * want.abs().max()
    # element 1 holds 3 real frames and one padding frame after them
    xp = x.clone()
    xp[1, 3] = x[1, 2]
    fp_, bp_ = ff.clone(), fb.clone()
    fp_[1, 2], bp_[1, 2] = ff[1, 1], fb[1, 1]
    mp = m.clone()
    mp[1, 3] = m[1, 2]
    got = propainter.feature_propagation(
        port_g.feat_prop_module, xp, fp_, bp_, mp,
        valid_len=torch.tensor([4, 3]))
    want3, _ = ref.propagation(ref.Ops(), ref_g.feat_prop_module,
                               _nc(x[1:, :3]), _nc(ff[1:, :2]),
                               _nc(fb[1:, :2]), _nc(m[1:, :3]))
    want3 = want3.permute(0, 1, 3, 4, 2)
    assert (got[1, :3] - want3[0]).abs().max() < 1e-3 * want3.abs().max()
    assert (got[0] - want[0]).abs().max() < 1e-3 * want.abs().max()


@torch.no_grad()
def test_sparse_attention_matches_reference(weights):
    """One block's attention over a batch of two windows whose masks flag
    different windows (and some none), against the reference's loop over
    batch elements, for both key-frame parities. The grid is ProPainter's
    token map of a 128x224 frame padded to whole windows (3 x 3)."""
    port_g, _, ref_g, _ = weights
    torch.manual_seed(1)
    b, t, nl = 2, 6, 4
    hq, wq = 32, 56
    lh, lw = propainter.tfocal.token_grid((hq, wq))
    x = torch.randn(b, t, lh, lw, 512)
    masks_q = np.zeros((b, nl, hq, wq), np.uint8)
    masks_q[0, :, 1:4, 1:5] = 1            # the top-left window
    masks_q[1, 2, 31:32, 55:56] = 1        # the bottom-right one
    ph, pw = propainter.padded_grid(lh, lw)
    nwin = (ph // 5) * (pw // 9)
    flags = np.stack([propainter.window_flags(masks_q[i], lh, lw).any(0)
                      for i in range(b)])
    assert flags.any(1).all() and not flags.all(1).any()
    assert not np.array_equal(flags[0], flags[1])
    flagged = [i * nwin + w for i in range(b) for w in range(nwin)
               if flags[i, w]]
    frame = [i * nwin + w for i in range(b) for w in range(nwin)
             if not flags[i, w]]
    kfs = tuple(torch.tensor([propainter.key_frames(nl, t - nl, nl, par)]
                             * len(flagged)) for par in range(2))
    rows = propainter.SparseRows(torch.tensor(flagged), torch.tensor(frame),
                                 kfs, tuple(torch.ones_like(k, dtype=bool)
                                            for k in kfs))
    pool = F.max_pool2d(torch.from_numpy(masks_q).float().reshape(
        -1, 1, hq, wq), 7, 3, 3).reshape(b, nl, lh, lw, 1)
    for i, par in enumerate((0, 1)):
        pa = port_g.transformers.transformer[i].attention
        ra = ref_g.transformers.transformer[i].attention
        got = propainter.sparse_attention(pa, x, rows, par)
        want, n_flag = ref.sparse_attention(ref.Ops(), ra, x, pool,
                                            torch.arange(par, t, 2))
        assert n_flag == len(flagged)
        assert (got - want).abs().max() < 1e-4 * want.abs().max()


def test_key_table_dedups_wrapped_rolls():
    """At a grid of two windows a side the rolls wrap onto the window's
    own tokens: each slot is unique, its bias the log of its count, and
    the counts add up to the 45 + 148 keys of the reference."""
    idx, bias, nsrc = propainter.key_table(10, 18)
    npool = (10 // 4) * (18 // 4)
    assert nsrc == 10 * 18 + npool + 1
    for r, lb in zip(idx, bias):
        fine = r[r < 180]
        assert len(set(fine.tolist())) == len(fine)
        counts = np.exp(lb[r < 180])
        assert round(float(counts.sum())) == 45 + 148
        assert list(r[(r >= 180) & (r < nsrc - 1)]) == \
            list(range(180, 180 + npool))


@torch.no_grad()
def test_propainter_call_matches_reference(weights, monkeypatch):
    """The whole serving call (RAFT at 3 iterations, image propagation,
    encoder, windows batched two at a time with end padding, blend,
    composite) against the reference's protocol, window by window at its
    own length; with keep_flows the call leaves its own RAFT flows, which
    are the reference's."""
    port_g, port_r, ref_g, ref_r = weights
    monkeypatch.setattr(raft, "ITERS", 3)
    fr, mk = _video(7)
    inp = SlidingWindowInpainter(port_g, max_batch=2, dtype=torch.float32,
                                 out_dtype=np.uint8, device="cpu",
                                 flow_model=port_r)
    from e2fgvi_tpu_torch.utils.timing import StageTimer
    timer = StageTimer()
    inp.keep_flows = True
    got = np.stack(inp(fr, mk.astype(np.float32), fr, mk, timer=timer))
    want, flows, n_flag = ref.inpaint(ref_g, ref_r, fr, mk, fr, mk,
                                      np.uint8, CPU, iters=3)
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    for kept, ref_flow in zip(inp.kept_flows, flows):
        assert kept.shape == (6, 128, 128, 2)
        assert (kept - ref_flow).abs().max() < 1e-4
    inp.keep_flows = False
    inp(fr[:3], mk[:3].astype(np.float32), fr[:3], mk[:3])
    assert inp.kept_flows is None
    inside = want[mk[..., 0] > 0]
    assert inside.std() > 10                # not a saturated output
    totals = timer.totals()
    assert totals["attn_rows_flagged"] == n_flag
    assert totals["attn_rows_flagged.transformer"] == n_flag
    assert totals["raft_iterations"] == 3 * 2 * 6
    for span in ("flows", "img_prop", "encode", "feat_prop", "transformer",
                 "decode", "blend", "fetch", "prep", "raft_corr",
                 "raft_update"):
        assert totals[span] > 0, span


@pytest.mark.parametrize("cin,cout,k,stride,pad", [
    (3, 64, (7, 7), 2, (3, 3)), (64, 96, (3, 3), 2, (1, 1)),
    (64, 96, (1, 1), 2, (0, 0)), (384, 128, (1, 5), 1, (0, 2)),
    (384, 128, (5, 1), 1, (2, 0)), (324, 256, (1, 1), 1, (0, 0))])
def test_raft_conv_gemm_is_conv2d(cin, cout, k, stride, pad):
    """RAFT's convolutions on the card (one GEMM over the strided patches
    of the zero-padded map) equal conv2d, at RAFT's kernel shapes and
    strides on an odd-sized map."""
    torch.manual_seed(0)
    x = torch.randn(2, 17, 23, cin)
    w = torch.randn(cout, cin, *k) / (cin * k[0] * k[1]) ** 0.5
    b = torch.randn(cout)
    got = raft.conv_gemm(x, w, b, stride, pad)
    want = F.conv2d(_nc(x), w, b, stride=stride, padding=pad)
    assert got.shape == want.movedim(1, -1).shape
    assert (got - want.movedim(1, -1)).abs().max() < 1e-5
