"""RAFT on C (kernels/conv.py raft_conv) on the CPU: refine and
video_flows on the state buffer against their concatenating form before C
and that form in float64, the entry point's calls a refine, and the reader
of its launch counter. The kernel's own CPU tests are in
tests/test_torch_conv.py; the kernel runs in
tests/test_torch_propainter_cuda.py."""

import copy
import math
import os
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from e2fgvi_tpu_torch.kernels import conv
from e2fgvi_tpu_torch.models import raft

ROOT = Path(__file__).resolve().parents[1]
# RAFT's convolutions on C (update_operands' names): (Cin, Cout, kh, kw)
COVERED = {"convc1": (324, 256, 1, 1), "convc2": (256, 192, 3, 3),
           "convf2": (128, 64, 3, 3), "conv": (256, 126, 3, 3),
           "fh1": (128, 256, 3, 3), "fh2": (256, 2, 3, 3),
           "mask0": (128, 256, 3, 3), "mask2": (256, 576, 1, 1),
           "zr1": (384, 256, 1, 5), "q1": (384, 128, 1, 5),
           "zr2": (384, 256, 5, 1), "q2": (384, 128, 5, 1)}


def _update_concatenating(ub, net, inp, corr, flow):
    """update() before C: each convolution on conv_gemm, the GRU's inputs
    assembled by torch.cat."""
    me = ub.encoder

    def conv(x, m):
        kh, kw = m.kernel_size
        return raft.conv_gemm(x, m.weight, m.bias, 1, (kh // 2, kw // 2))
    c = F.relu(conv(corr, me.convc1))
    c = F.relu(conv(c, me.convc2))
    f = F.relu(conv(flow, me.convf1))
    f = F.relu(conv(f, me.convf2))
    m = F.relu(conv(torch.cat([c, f], -1), me.conv))
    x = torch.cat([inp, m, flow], -1)
    g = ub.gru
    for z, r, q in ((g.convz1, g.convr1, g.convq1),
                    (g.convz2, g.convr2, g.convq2)):
        hx = torch.cat([net, x], -1)
        zt = torch.sigmoid(conv(hx, z))
        rt = torch.sigmoid(conv(hx, r))
        qt = torch.tanh(conv(torch.cat([rt * net, x], -1), q))
        net = (1 - zt) * net + zt * qt
    fh = ub.flow_head
    return net, conv(F.relu(conv(net, fh.conv1)), fh.conv2)


def _refine_concatenating(r, fmap1, fmap2, net, inp, iters):
    """refine() before C."""
    levels = raft.corr_pyramid(fmap1, fmap2)
    n, h, w, _ = fmap1.shape
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    coords0 = torch.stack([xs, ys], -1).to(fmap1.dtype)[None].expand(
        n, h, w, 2)
    coords1 = coords0
    ub = r.update_block
    for _ in range(iters):
        corr = raft.corr_lookup(levels, coords1)
        net, delta = _update_concatenating(ub, net, inp, corr,
                                           coords1 - coords0)
        coords1 = coords1 + delta
    m = F.relu(raft.conv_gemm(net, ub.mask[0].weight, ub.mask[0].bias, 1,
                            (1, 1)))
    mask = 0.25 * raft.conv_gemm(m, ub.mask[2].weight, ub.mask[2].bias, 1,
                               (0, 0))
    return raft.upsample_flow(coords1 - coords0, mask)


@pytest.fixture(scope="module")
def seeded_raft():
    bench = str(ROOT / "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness.weights_propainter import make_state_dicts
    torch.set_num_threads(2)
    r = raft.RAFT()
    r.load_state_dict(make_state_dicts(9876543210123, torch.device("cpu"))[
        "raft"], strict=True)
    return r.eval()


def _frames(t, h, w, shift=(3, 2), seed=0):
    """Smooth frames in [-1, 1], each the last shifted by `shift` px."""
    g = torch.Generator().manual_seed(seed)
    big = F.interpolate(torch.rand((1, 3, (h + 4 * t) // 8, (w + 4 * t) // 8),
                                   generator=g),
                        size=(h + 4 * t, w + 4 * t), mode="bilinear")[0]
    dx, dy = shift
    return torch.stack([big[:, dy * i: dy * i + h, dx * i: dx * i + w]
                        for i in range(t)]).permute(0, 2, 3, 1) * 2 - 1


def _distances(got, want, want64):
    """max |got - want64| and max |want - want64|: each path's distance
    from the float64 form."""
    return (float((got.double() - want64).abs().max()),
            float((want.double() - want64).abs().max()))


@torch.no_grad()
def test_refine_matches_the_concatenating_form(seeded_raft):
    """refine on the state buffer (C's plain path on the CPU) against
    refine before C, on 4 fields at 128 x 192 (a 16 x 24 grid), 3
    iterations: the GEMMs' order changed (z and r stacked, q's inputs
    rotated), so the two differ by float32 rounding, which the iterations
    carry (the form before C lands 3.5e-6 of the flows' scale from
    float64): the new form no farther from float64 than the old."""
    r = seeded_raft
    f = _frames(3, 128, 192)
    fmap = raft.encode(r.fnet, f)
    net, inp = raft.context(r, f)
    args = (torch.cat([fmap[:2], fmap[1:]]), torch.cat([fmap[1:], fmap[:2]]),
            torch.cat([net[:2], net[1:]]), torch.cat([inp[:2], inp[1:]]))
    got = raft.refine(r, *args, iters=3)
    want = _refine_concatenating(r, *args, 3)
    want64 = _refine_concatenating(copy.deepcopy(r).double(),
                                   *(a.double() for a in args), 3)
    assert float(want.abs().max()) > 0.5
    new, old = _distances(got, want, want64)
    assert new <= 1.5 * old, (new, old)
    assert float((got - want).abs().max()) <= 2 * old


def _video_flows64(r, frames, iters, chunk):
    """video_flows' loop in float64 with refine before C."""
    r, frames = copy.deepcopy(r).double(), frames.double()
    fwd, bwd = [], []
    step = chunk // 2
    for s in range(0, len(frames) - 1, step):
        e = min(s + step, len(frames) - 1)
        clip = frames[s: e + 1]
        fmap = raft.encode(r.fnet, clip)
        net, inp = raft.context(r, clip)
        k = e - s
        flows = _refine_concatenating(
            r, torch.cat([fmap[:k], fmap[1:]]), torch.cat([fmap[1:],
                                                           fmap[:k]]),
            torch.cat([net[:k], net[1:]]), torch.cat([inp[:k], inp[1:]]),
            iters)
        fwd.append(flows[:k])
        bwd.append(flows[k:])
    return torch.cat(fwd), torch.cat(bwd)


@torch.no_grad()
def test_video_flows_match_the_concatenating_form(seeded_raft, monkeypatch):
    """video_flows with refine on C's path against the same with refine
    before C and that form in float64: 6 frames in chunks of 4 fields (3
    refines, the last ragged); the new form no farther from float64."""
    r = seeded_raft
    f = _frames(6, 64, 96, shift=(2, 1), seed=1)
    got = raft.video_flows(r, f, iters=2, chunk=4)
    monkeypatch.setattr(raft, "refine", lambda r, f1, f2, net, inp, iters,
                        spans: _refine_concatenating(r, f1, f2, net, inp,
                                                     iters))
    want = raft.video_flows(r, f, iters=2, chunk=4)
    want64 = _video_flows64(r, f, 2, 4)
    for a, b, b64 in zip(got, want, want64):
        assert a.shape == (5, 64, 96, 2) and float(b.abs().max()) > 0.1
        new, old = _distances(a, b, b64)
        assert new <= 1.5 * old, (new, old)


@torch.no_grad()
def test_refine_calls_c2_for_every_covered_convolution(seeded_raft,
                                                       monkeypatch):
    """Each iteration runs ten convolutions through raft_conv (all of
    update's but convf1) and the mask head two more, each with the
    operands update_operands made once: 10 iters + 2 calls a refine, so a
    video of T frames makes 202 ceil((T - 1) / 8) launches at ITERS 20
    and FIELD_CHUNK 16 (PERF.md's prediction for the pool)."""
    calls = []
    orig = conv.raft_conv

    def record(x, ops, act="none", **k):
        calls.append((tuple(ops.weight.shape), act))
        return orig(x, ops, act, **k)

    monkeypatch.setattr(conv, "raft_conv", record)
    made = []
    orig_ops = raft.update_operands
    monkeypatch.setattr(raft, "update_operands",
                        lambda ub: made.append(1) or orig_ops(ub))
    r = seeded_raft
    f = _frames(4, 64, 96)
    raft.video_flows(r, f, iters=3, chunk=4)
    refines = math.ceil((4 - 1) / 2)
    assert len(made) == refines
    assert len(calls) == refines * (10 * 3 + 2)
    per_iter = calls[:10]
    assert [(s[0], s[1], s[2], s[3], a) for s, a in per_iter] == [
        (256, 324, 1, 1, "relu"), (192, 256, 3, 3, "relu"),
        (64, 128, 3, 3, "relu"), (126, 256, 3, 3, "relu"),
        (256, 384, 1, 5, "zr"), (128, 384, 1, 5, "gru"),
        (256, 384, 5, 1, "zr"), (128, 384, 5, 1, "gru"),
        (256, 128, 3, 3, "relu"), (2, 256, 3, 3, "none")]
    assert calls[30:32] == [((256, 128, 3, 3), "relu"),
                            ((576, 256, 1, 1), "none")]
    covered = {(cout, cin, kh, kw) for cin, cout, kh, kw in
               COVERED.values()}
    assert {s for s, _ in calls} == covered
    pool = [25, 60, 80, 104]
    assert sum(202 * math.ceil((t - 1) / (raft.FIELD_CHUNK // 2))
               for t in pool) / len(pool) == 1717.0


def _reader():
    bench = str(ROOT / "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness import common
    return common.reader("raft_conv_launches_per_video.propainter")


def test_launch_reader():
    """perfbench/metrics/raft_conv_launches_per_video.py: the program's
    raft_conv_launches per traced video; None where the program has no
    such counter (a parent without C) or no video completed; 0 read as 0."""
    read = _reader().read
    run = {"kind": "serve", "frames": 269, "latencies": [1.0] * 4,
           "stages_ms": {"flows": 100.0, "raft_conv_launches": 6868,
                         "raft_conv_launches.raft_update": 6868}}
    assert read(run) == 1717.0
    assert read(dict(run, stages_ms={"flows": 100.0,
                                     "raft_conv_launches": 0})) == 0
    assert read(dict(run, stages_ms={"flows": 100.0})) is None
    assert read(dict(run, stages_ms=None)) is None
    assert read(dict(run, latencies=[])) is None
    assert os.path.basename(_reader().__file__) == \
        "raft_conv_launches_per_video.py"
