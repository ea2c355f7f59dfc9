"""Wan2.1-VACE on the port (models/wan_dit.py, models/wan_vae.py,
models/wan_vace.py, the Wan-VACE path of data/pipeline.py) against the
benchmark's plain reference (perfbench/reference/wan_vace.py), on the CPU
at a tiny size (dim 64, 2 heads, 4 layers with context blocks at 0 and 2,
VAE dim 8, 64 x 64 frames, 9 frames) with seeded weights
(perfbench/harness/weights_wan_vace.py). Both sides run in float32 here,
so they differ by float32 rounding in another order: the tolerances are
a few hundred float32 ulps of each quantity's scale (1e-5 to 1e-4
relative), except where uint8 truncation may flip a level."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import work_wan_vace  # noqa: E402
from harness.weights_wan_vace import make_contexts, make_state_dicts  # noqa
from reference import wan_vace as ref  # noqa: E402
from reference.model import Ops  # noqa: E402

from e2fgvi_tpu_torch.data.pipeline import SlidingWindowInpainter  # noqa
from e2fgvi_tpu_torch.models import wan_dit, wan_vace  # noqa: E402
from e2fgvi_tpu_torch.utils.timing import NO_SPANS, StageTimer  # noqa

SEED = 9876543210123
CPU = torch.device("cpu")
TINY = {"dit": dict(dim=64, ffn_dim=128, freq_dim=32, text_dim=32,
                    text_len=16, in_dim=16, out_dim=16, num_heads=2,
                    num_layers=4, patch_size=(1, 2, 2), eps=1e-6,
                    vace_layers=(0, 2), vace_in_dim=96),
        "vae": dict(dim=8, z_dim=16, dim_mult=(1, 2, 4, 4),
                    num_res_blocks=2, temperal_downsample=(False, True, True))}
STEPS, SHIFT, GUIDANCE = 3, 5.0, 5.0
OPS = Ops()


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(2)
    sds = make_state_dicts(SEED, CPU, TINY)
    rdit, rvae = ref.build(TINY, sds, CPU)
    port = wan_vace.build(TINY, steps=STEPS)
    port.dit.load_state_dict(sds["dit"], strict=True)
    port.vae.load_state_dict(sds["vae"], strict=True)
    ctx = make_contexts(SEED, CPU, 16, 32, (4, 6))
    port.set_prompts(*ctx)
    port.eval()
    return port, rdit, rvae, ctx


def _latent_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((16, 3, 8, 8), generator=g)
    vctx = torch.randn((96, 3, 8, 8), generator=g)
    return x, vctx


def test_one_block_matches(models):
    port, rdit, _, (ctx, _) = models
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 48, 64), generator=g)
    e0 = torch.randn((1, 6, 64), generator=g) * 0.3
    c = torch.randn((1, 16, 64), generator=g)
    grid = (3, 4, 4)
    with torch.no_grad():
        got = port.dit.blocks[1](x, e0, port.dit.rope(grid, CPU), c)
        want = ref.block_forward(OPS, rdit.blocks[1], x[0], e0[0], grid,
                                 ref.rope_freqs(32), c[0], 2, 1e-6)
    assert rel(got[0], want) < 1e-5


@pytest.mark.parametrize("grid", [(3, 4, 4), (2, 5, 3)])
def test_rope_on_a_3d_grid(grid):
    """The port's float32 rotation equals Wan's complex float64 one; at
    head dim 128 the split is 44 / 42 / 42."""
    g = torch.Generator().manual_seed(2)
    s = int(np.prod(grid))
    x = torch.randn((1, s, 2, 128), generator=g)
    cos, sin = wan_dit.rope_angles(grid, 128, CPU)
    got = wan_dit.rope_apply(x, cos, sin)
    want = ref.rope_apply(x[0], grid, ref.rope_freqs(128))
    assert (got[0] - want).abs().max() < 1e-5
    assert cos.shape == (s, 64)
    # a token's t-pairs turn with its frame only, its w-pairs with its
    # column only
    f, h, w = grid
    idx = np.arange(s).reshape(grid)
    a = torch.atan2(sin, cos)
    assert torch.allclose(a[idx[1, 0, 0], :22], a[idx[1, h - 1, w - 1], :22])
    assert torch.allclose(a[idx[0, 0, w - 1], 43:], a[idx[f - 1, h - 1,
                                                         w - 1], 43:])


def test_dit_forward_with_hints(models):
    """The whole DiT (context blocks, hints after main blocks 0 and 2, the
    head and unpatchify) against the reference."""
    port, rdit, _, (ctx, _) = models
    x, vctx = _latent_inputs()
    t = torch.tensor([937.0])
    with torch.no_grad():
        got = port.dit(x, t, vctx, ctx)
        want = ref.dit_forward(OPS, rdit, x, t, vctx, ctx)
        without = ref.dit_forward(OPS, rdit, x, t, vctx, ctx, hints_on=False)
    assert got.shape == (16, 3, 8, 8)
    assert rel(got, want) < 1e-5
    assert rel(without, want) > 0.1


def test_context_branch_is_live(models):
    """Zeroing after_proj (VACE's zero initialisation) changes the
    output: the seeded weights make the context branch do work."""
    port, _, _, (ctx, _) = models
    x, vctx = _latent_inputs()
    t = torch.tensor([624.0])
    with torch.no_grad():
        base = port.dit(x, t, vctx, ctx)
        saved = [b.after_proj.weight.clone() for b in port.dit.vace_blocks]
        for b in port.dit.vace_blocks:
            b.after_proj.weight.zero_()
            b.after_proj.bias.zero_()
        try:
            cut = port.dit(x, t, vctx, ctx)
        finally:
            for b, w in zip(port.dit.vace_blocks, saved):
                b.after_proj.weight.copy_(w)
        other = port.dit(x, t, vctx * 0.5, ctx)
    assert rel(cut, base) > 0.1
    assert rel(other, base) > 0.01


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_vae_cached_chunks_equal_the_whole_clip(models, frames):
    """Encoding the first frame and then 4 at a time, and decoding a latent
    frame at a time, each through the frame cache, equals the causal
    convolutions over the whole clip."""
    port, _, rvae, _ = models
    g = torch.Generator().manual_seed(frames)
    clip = torch.rand((3, frames, 64, 64), generator=g) * 2 - 1
    with torch.no_grad():
        z = port.vae.encode(clip)
        zr = ref.vae_encode(OPS, rvae, clip)
        assert z.shape == (16, 1 + (frames - 1) // 4, 8, 8)
        assert rel(z, zr) < 1e-5
        video = port.vae.decode(zr)
        want = ref.vae_decode(OPS, rvae, zr)
    assert video.shape == clip.shape
    assert (video - want).abs().max() < 1e-4


def test_schedule_sigmas():
    """Wan's shifted schedule: sigma_max 1 - 1/1000 as float32, shift
    s sigma / (1 + (s - 1) sigma), integer timesteps, a final 0."""
    for steps, shift in ((4, 5.0), (50, 5.0), (3, 3.0)):
        t, s = wan_vace.schedule(steps, shift)
        rt, rs = ref.schedule(steps, shift)
        assert np.array_equal(t, rt) and np.array_equal(s, rs)
        assert s.dtype == np.float32 and s[-1] == 0 and len(s) == steps + 1
        assert np.all(np.diff(s) < 0)
    t, s = wan_vace.schedule(4, 5.0)
    assert list(t) == [999, 937, 833, 624]
    base = np.float32(0.999) * (1 - np.arange(4) / 4)
    assert np.allclose(s[:4], 5 * base / (1 + 4 * base), rtol=1e-6)


def test_sampling_loop_from_the_same_noise(models):
    port, rdit, _, (ctx, ctx_null) = models
    _, vctx = _latent_inputs(3)
    t, s = wan_vace.schedule(STEPS, SHIFT)
    port.seed = 77
    with torch.no_grad():
        got, kept = port.sample(vctx, torch.from_numpy(t.astype(np.float32)),
                                s, NO_SPANS, keep_step=1)
        noise = torch.randn((16, 3, 8, 8),
                            generator=torch.Generator().manual_seed(77))
        want, seen = ref.sample(OPS, rdit, vctx, noise, ctx, ctx_null,
                                STEPS, SHIFT, GUIDANCE)
        v = ref.guided_velocity(OPS, rdit, seen[1],
                                torch.tensor([float(t[1])]), vctx, ctx,
                                ctx_null, GUIDANCE)
    assert rel(got, want) < 1e-4
    assert kept["step"] == 1 and float(kept["timestep"]) == t[1]
    assert rel(kept["latent"], seen[1]) < 1e-4
    assert rel(kept["velocity"], v) < 1e-4


def _video(t, h=64, w=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    fr = (torch.rand((t, h, w, 3), generator=g) * 255).to(torch.uint8)
    mk = np.zeros((t, h, w, 1), np.uint8)
    for i in range(t):
        mk[i, 10 + i: 40 + i, 12 + 2 * i: 44 + 2 * i] = 1
    return fr.numpy(), mk


def test_serving_call_and_composite(models):
    """SlidingWindowInpainter's Wan-VACE path against the reference's whole
    path from the same noise: frames within a level where truncation may
    flip, outside the mask exactly the input; it keeps the asked step."""
    port, rdit, rvae, (ctx, ctx_null) = models
    frames, masks = _video(9)
    port.seed = 5
    inp = SlidingWindowInpainter(port, dtype=torch.float32,
                                 out_dtype=np.uint8, device=CPU)
    inp.keep_step = 2
    got = np.stack(inp(frames, masks.astype(np.float32), frames, masks))
    noise = torch.randn((16, 3, 8, 8),
                        generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want, final = ref.inpaint(OPS, rdit, rvae, frames, masks, noise, ctx,
                                  ctx_null, STEPS, SHIFT, GUIDANCE)
    inside = masks[..., 0] != 0
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d[~inside].max() == 0
    assert (got[~inside] == frames[~inside]).all()
    assert d.max() <= 1 and d[inside].mean() < 0.01
    kept = inp.kept_step
    assert kept["step"] == 2 and rel(kept["final"], final) < 1e-4
    assert kept["context"].shape == (96, 3, 8, 8)


def test_serving_pads_to_a_clip_and_records_spans(models):
    """A 7-frame 56 x 60 video is padded to 9 frames of 64 x 64 and cropped
    back; a timed call records the Wan-VACE spans and counts two DiT
    forwards a step over S tokens each."""
    port, _, _, _ = models
    frames, masks = _video(7, 56, 60, seed=1)
    inp = SlidingWindowInpainter(port, dtype=torch.float32,
                                 out_dtype=np.uint8, device=CPU)
    timer = StageTimer()
    out = inp(frames, masks.astype(np.float32), frames, masks, timer=timer)
    assert len(out) == 7 and out[0].shape == (56, 60, 3)
    outside = masks[..., 0] == 0
    assert (np.stack(out)[outside] == frames[outside]).all()
    tot = timer.totals()
    for span in ("prep", "vae_encode", "dit", "dit_context", "vae_decode",
                 "blend", "fetch"):
        assert tot[span] > 0, span
    assert tot["dit_context"] < tot["dit"]
    assert tot["dit_forwards"] == 2 * STEPS
    assert tot["dit_tokens"] == 2 * STEPS * 3 * 4 * 4
    assert inp.kept_step is None


def test_work_counts_match_the_flop_counter(models):
    """The analytic count of harness/work_wan_vace.py equals torch's
    FlopCounterMode over the reference's whole path (two encodes, STEPS x 2
    DiT forwards, one decode), and the self-attention's part equals the
    counter's over the attention products alone."""
    _, rdit, rvae, (ctx, ctx_null) = models
    frames, masks = _video(9, seed=2)
    noise = torch.zeros((16, 3, 8, 8))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.inpaint(OPS, rdit, rvae, frames, masks, noise, ctx, ctx_null,
                    STEPS, SHIFT, GUIDANCE)
    w = work_wan_vace.video_work(TINY, 9, 64, 64, STEPS, 2)
    assert fc.get_total_flops() == w["model_flops"]
    g = torch.Generator().manual_seed(3)
    q, k, v = torch.randn((3, 48, 2, 32), generator=g)
    with FlopCounterMode(display=False) as fa:
        ref.attention(OPS, q, k, v)
    calls = 2 * STEPS * (4 + 2)
    assert w["dit_attn_flops"] == calls * fa.get_total_flops()
    assert w["dit_attn_bytes"] == calls * 4 * 48 * 64 * 2
    assert work_wan_vace.tokens(TINY["dit"], 81, 480, 832) == 32760


def test_cli_runs_wan_vace(tmp_path, monkeypatch):
    """cli.inpaint --model wan_vace with seeded weights and prompts at the
    tiny widths writes the video."""
    import cv2
    from e2fgvi_tpu_torch.cli import inpaint
    vid, mdir = tmp_path / "v", tmp_path / "m"
    vid.mkdir()
    mdir.mkdir()
    frames, masks = _video(5, 48, 64, seed=3)
    for i in range(5):
        cv2.imwrite(str(vid / f"{i:05d}.jpg"), frames[i])
        cv2.imwrite(str(mdir / f"{i:05d}.png"), masks[i, ..., 0] * 255)
    monkeypatch.setattr(wan_vace, "PUBLISHED", dict(TINY, steps=2,
                                                    shift=5.0, guidance=5.0))
    out = inpaint.main(["-v", str(vid), "-m", str(mdir), "-c", "none",
                        "--model", "wan_vace", "--random_weights",
                        "--device", "cpu", "--no_show", "--out",
                        str(tmp_path / "out")])
    assert os.path.exists(out)
