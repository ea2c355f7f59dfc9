"""ProPainter's pieces of the port on the card: K1 at Cin 128 (16 groups
of 8 channels) in both dtypes, the float32 feature propagation with every
convolution on C (kernels/conv.py conv3x3), K3 on the sparse transformer's
flagged rows, C at each of RAFT's covered convolutions (raft_conv) and in
a whole refine, and the whole serving call under sync debug mode
"error".

CUDA kernels have no CPU mode, so these tests skip where CUDA is absent.
On a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_propainter_cuda.py -q -m cuda
"""

import os
import sys

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


# (n, h, w): a ragged last tile, and ProPainter's 120x212 quarter grid on
# a few rows
@pytest.mark.parametrize("size", [(2, 9, 13), (1, 3, 212)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_cin128_matches_plain(gen, dtype, size):
    """K1's 8-channels-a-group form (Cin 128, G 16, 1152-wide K) against
    its plain version, with flow_2 = flow_1 as ProPainter calls it and
    max_residue 3."""
    n, h, w = size
    x = _randn(gen, n, h, w, 128).to(dtype)
    head = _randn(gen, n, h, w, 27 * 16).to(dtype)
    f1 = _randn(gen, n, h, w, 2, std=4)
    f1[:, :, -3:, 0] += 60.0            # samples far outside the image
    wt = _randn(gen, 128, 128, 3, 3, std=0.05).to(dtype)
    b = _randn(gen, 128).to(dtype)
    before = deform.LAUNCHES["deform_conv"]
    got = deform.modulated_deform_conv2d_head(x, head, f1, f1, wt, b,
                                              max_residue=3.0)
    assert deform.LAUNCHES["deform_conv"] == before + 1
    assert got.dtype == dtype and got.shape == (n, h, w, 128)
    want = deform.deform_conv_head_plain(x.float(), head.float(), f1, f1,
                                         wt.float(), b.float(), 3.0)
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 2e-5
    else:
        assert (got.float() - want).abs().max() / want.abs().max() < 2e-2
    ops = deform.conv_operands(wt, b, dtype, 16)
    assert torch.equal(deform.modulated_deform_conv2d_head(
        x, head, f1, f1, wt, b, max_residue=3.0, operands=ops), got)


def test_feature_propagation_f32_runs_every_conv_on_c1(gen):
    """In float32 on the card every convolution of the propagation takes
    C, those of Cin 261 and 258 on zero-padded channels, and the result
    is the CPU's plain propagation's: 4 frames, two batch elements."""
    from e2fgvi_tpu_torch.kernels import conv
    from e2fgvi_tpu_torch.models import propainter
    torch.manual_seed(0)
    mod = propainter.BidirectionalPropagation().eval()
    for m in mod.modules():
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.normal_(m.weight, std=0.5 / np.sqrt(
                m.weight[0].numel()))
            torch.nn.init.normal_(m.bias, std=0.1)
    for a in mod.deform_align.values():
        torch.nn.init.normal_(a.weight, std=0.02)
    t, h, w = 4, 16, 24
    x = _randn(gen, 2, t, h, w, 128)
    ff = _randn(gen, 2, t - 1, h, w, 2, std=1.5)
    fb = -ff + _randn(gen, 2, t - 1, h, w, 2, std=0.3)
    m = (_randn(gen, 2, t, h, w, 2) > 0.5).float()
    before = conv.LAUNCHES["conv3x3"]
    with torch.inference_mode():
        got = propainter.feature_propagation(mod.cuda(), x, ff, fb, m)
        # each pass: 2 backbone convs a frame, 4 offset convs a step; fuse 2
        assert conv.LAUNCHES["conv3x3"] - before == \
            2 * (2 * t + 4 * (t - 1)) + 2
        want = propainter.feature_propagation(
            mod.cpu(), *(v.cpu() for v in (x, ff, fb, m)))
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err < 1e-5, err


def _rows(flags, n_local, nv, nr, device):
    """propainter.SparseRows of a batch from (B, nwin) bool flags, every
    window with nv locals and nr references."""
    from e2fgvi_tpu_torch.models import propainter
    b, nwin = flags.shape
    flagged = [i * nwin + w for i in range(b) for w in range(nwin)
               if flags[i, w]]
    frame = [i * nwin + w for i in range(b) for w in range(nwin)
             if not flags[i, w]]
    kfs, kvs = [], []
    for par in range(2):
        k = propainter.key_frames(nv, nr, n_local, par)
        kfs.append(torch.tensor([k] * len(flagged), dtype=torch.long,
                                device=device).reshape(len(flagged), -1))
        kvs.append(torch.ones_like(kfs[-1], dtype=torch.bool))
    t = torch.tensor
    return propainter.SparseRows(t(flagged, device=device),
                                 t(frame, device=device), tuple(kfs),
                                 tuple(kvs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_attention_k3_flagged_rows(gen, dtype):
    """The sparse attention on the card (K3 on the flagged rows over the
    deduplicated key table, SDPA on the frame rows) against its plain
    version on the CPU, two batch elements flagging different windows,
    at ProPainter's 40x71 token grid (64 windows) for 7 frames."""
    from e2fgvi_tpu_torch.models import propainter
    torch.manual_seed(0)
    attn = propainter.SparseWindowAttention().cuda()
    for m in (attn.key, attn.query, attn.value, attn.proj):
        torch.nn.init.normal_(m.weight, std=512 ** -0.5)
    x = _randn(gen, 2, 7, 40, 71, 512)
    flags = np.zeros((2, 64), bool)
    flags[0, 9:30] = True
    flags[1, 40:52] = True
    before = fa.LAUNCHES["focal_attention"]
    got = propainter.sparse_attention(
        attn.to(dtype), x.to(dtype), _rows(flags, 5, 4, 2, "cuda"), 1)
    assert fa.LAUNCHES["focal_attention"] == before + 1
    want = propainter.sparse_attention(
        attn.float().cpu(), x.to(dtype).float().cpu(),
        _rows(flags, 5, 4, 2, "cpu"), 1)
    err = (got.float().cpu() - want).abs().max() / want.abs().max()
    assert err < (1e-5 if dtype == torch.float32 else 3e-2), err


def test_propainter_call_does_not_synchronize(gen, monkeypatch):
    """A whole ProPainter call on the card (RAFT at 3 iterations, 128x128,
    9 frames, two window batches) with sync debug mode "error" inside
    RAFT, the image propagation and every window batch: none of them
    waits for the device; the output is the same call's without, to a
    level where cuDNN's picks may differ."""
    from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter
    from e2fgvi_tpu_torch.models import propainter, raft
    torch.manual_seed(0)
    g = propainter.Generator().cuda().to(torch.bfloat16).eval()
    r = raft.RAFT().cuda().eval()
    for mod in list(g.modules()) + list(r.modules()):
        if isinstance(mod, torch.nn.Conv2d):
            torch.nn.init.normal_(mod.weight, std=0.5 / np.sqrt(
                mod.weight[0].numel()))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (9, 128, 128, 3), dtype=np.uint8)
    masks = np.zeros((9, 128, 128, 1), np.uint8)
    masks[:, 40:90, 30:80] = 1
    inp = SlidingWindowInpainter(g, max_batch=1, dtype=torch.bfloat16,
                                 out_dtype=np.uint8, flow_model=r)
    orig = raft.video_flows
    monkeypatch.setattr(raft, "video_flows",
                        lambda net, f, **k: orig(net, f, iters=3, **k))
    want = inp(frames, masks.astype(np.float32), frames, masks)

    def strict(fn):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    for mod, name in ((raft, "video_flows"),
                      (propainter, "image_propagation"),
                      (propainter, "window_stage")):
        monkeypatch.setattr(mod, name, strict(getattr(mod, name)))
    got = inp(frames, masks.astype(np.float32), frames, masks)
    diff = np.abs(np.stack(got).astype(np.int32) - np.stack(want))
    assert diff.max() <= 1 and diff.mean() < 1e-2


# C (kernels/conv.py raft_conv): each of RAFT's covered convolutions
# (models/raft.py update_operands' names) at 848x480's 60x106 grid, on a
# chunk of FIELD_CHUNK = 16 fields and a ragged chunk of 6, in the state
# buffer's channel ranges where update() uses them; held to float64 as
# feat_prop's are (chip_smoke.C_MAX_ABS_F64)
C2_MAX_ABS_F64 = 1e-5
RAFT_GRID = (60, 106)
C2_ACTS = {"zr1": "zr", "zr2": "zr", "q1": "gru", "q2": "gru",
           "fh2": "none", "mask2": "none"}
C2_CONVS = ("convc1", "convc2", "convf2", "conv", "zr1", "q1", "zr2", "q2",
            "fh1", "fh2", "mask0", "mask2")


@pytest.fixture(scope="module")
def raft_ops():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from e2fgvi_tpu_torch.models import raft
    torch.manual_seed(0)
    return raft.update_operands(raft.RAFT().update_block.cuda())


def c2_args(gen, act, cin, cout, n, h, w):
    """A covered convolution's inputs as update() hands them over: "zr"
    reads the state's [net, x] and writes r * net into it, "gru" reads
    [x, r * net] and writes over net; the others a contiguous map."""
    from e2fgvi_tpu_torch.models import raft
    if act not in ("zr", "gru"):
        return {"x": _randn(gen, n, h, w, cin)}
    state = _randn(gen, n, h, w, raft.STATE)
    z = torch.sigmoid(_randn(gen, n, h, w, raft.HIDDEN_DIM))
    if act == "zr":
        return {"x": state[..., raft.HX], "out": state[..., raft.RNET],
                "net": state[..., raft.NET], "z": z}
    return {"x": state[..., raft.XR], "out": state[..., raft.NET],
            "net": state[..., raft.NET], "z": z}


@pytest.mark.parametrize("n", [16, 6])
@pytest.mark.parametrize("name", C2_CONVS)
def test_raft_conv_matches_float64(gen, raft_ops, name, n):
    """C against its plain form in float64 (ops.convs.conv2d and the
    epilogue) at RAFT's 848x480 shapes: within C2_MAX_ABS_F64, one launch,
    the state buffer's other channels untouched."""
    from e2fgvi_tpu_torch.kernels import conv
    ops, act = raft_ops[name], C2_ACTS.get(name, "relu")
    cout, cin = ops.weight.shape[:2]
    args = c2_args(gen, act, cin, cout, n, *RAFT_GRID)
    ref = {k: v.double() for k, v in args.items() if k != "out"}
    whole = args["x"]._base if args["x"]._base is not None else None
    before_buf = None if whole is None else whole.clone()
    before = conv.LAUNCHES["raft_conv"]
    got = conv.raft_conv(ops=ops, act=act, **args)
    assert conv.LAUNCHES["raft_conv"] == before + 1
    want = conv.conv_plain(ref["x"], ops.weight.double(), ops.bias.double(),
                           act=act, net=ref.get("net"), z=ref.get("z"))
    if act == "zr":
        wz, want = want
        assert (args["z"].double() - wz).abs().max() <= C2_MAX_ABS_F64
    assert got.shape == want.shape
    err = float((got.double() - want).abs().max())
    assert err <= C2_MAX_ABS_F64, err
    if before_buf is not None:
        from e2fgvi_tpu_torch.models import raft
        kept = raft.HX if act == "zr" else raft.XR
        assert torch.equal(whole[..., kept], before_buf[..., kept])


def test_raft_conv_does_not_synchronize(gen, raft_ops):
    """A launch of each epilogue under sync debug mode "error"."""
    from e2fgvi_tpu_torch.kernels import conv
    calls = [(name, c2_args(gen, C2_ACTS.get(name, "relu"),
                            raft_ops[name].weight.shape[1],
                            raft_ops[name].weight.shape[0], 2, 20, 40))
             for name in ("convc1", "zr1", "q2", "fh2")]
    for name, args in calls:                 # the library built and loaded
        conv.raft_conv(ops=raft_ops[name], act=C2_ACTS.get(name, "relu"),
                       **args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, args in calls:
            conv.raft_conv(ops=raft_ops[name],
                           act=C2_ACTS.get(name, "relu"), **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_refine_on_c2_matches_the_conv_gemm_path(gen, monkeypatch):
    """One refine of 4 seeded fields at 848x480 (the benchmark's seeded
    RAFT weights, 20 iterations) on C against the same refine with every
    convolution on raft.conv_gemm and the epilogue (chip_smoke.gemm_call:
    cuBLAS float32, TF32 off): each field's mean endpoint error within
    1e-4 px."""
    from chip_smoke import gemm_call
    from e2fgvi_tpu_torch.kernels import conv
    from e2fgvi_tpu_torch.models import raft
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness.weights_propainter import make_state_dicts
    r = raft.RAFT()
    r.load_state_dict(make_state_dicts(9876543210123, torch.device("cpu"))[
        "raft"], strict=True)
    r = r.cuda().eval()
    low = torch.rand((1, 3, 70, 120), generator=gen, device="cuda")
    big = torch.nn.functional.interpolate(low, size=(560, 960),
                                          mode="bilinear")[0]
    f = torch.stack([big[:, 3 * i: 3 * i + 480, 5 * i: 5 * i + 848]
                     for i in range(3)]).permute(0, 2, 3, 1) * 2 - 1
    with torch.inference_mode():
        fmap = raft.encode(r.fnet, f)
        net, inp = raft.context(r, f)
        args = (torch.cat([fmap[:2], fmap[1:]]),
                torch.cat([fmap[1:], fmap[:2]]),
                torch.cat([net[:2], net[1:]]), torch.cat([inp[:2], inp[1:]]))
        before = conv.LAUNCHES["raft_conv"]
        got = raft.refine(r, *args)
        assert conv.LAUNCHES["raft_conv"] - before == 10 * raft.ITERS + 2
        monkeypatch.setattr(conv, "raft_conv", gemm_call)
        want = raft.refine(r, *args)
    assert float(want.abs().mean()) > 1.0          # real motion
    epe = (got - want).norm(dim=-1).mean(dim=(1, 2))
    assert float(epe.max()) <= 1e-4, epe
