"""The port's HQ model against the JAX package and the reference golden:
soft composition with the bias conv, window_stage on a 20x72 token grid,
the generator golden, the converter round trip, strict loading across
variants, the pipeline at a mirror-padded size, and the inpaint CLI's
size choice."""

import argparse
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.convert.torch_loader import convert_generator
from e2fgvi_tpu.models import e2fgvi as jgen
from e2fgvi_tpu.models import tfocal as jtf
from e2fgvi_tpu_torch.cli import inpaint
from e2fgvi_tpu_torch.convert import from_jax
from e2fgvi_tpu_torch.data import pipeline
from e2fgvi_tpu_torch.models import e2fgvi as tgen
from e2fgvi_tpu_torch.models import tfocal
from test_generator_golden import fill_weight

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "generator_hq.npz")


def _bar(want):
    return 2e-3 * np.abs(want).max() + 2e-5


def _golden_sd(path):
    data = np.load(path)
    keys = [str(k) for k in data["keys"]]
    shapes = [ast.literal_eval(str(s)) for s in data["shapes"]]
    rng = np.random.default_rng(7)
    return {k: fill_weight(k, s, rng) for k, s in zip(keys, shapes)}


@pytest.fixture(scope="module")
def reference_sd():
    return _golden_sd(GOLDEN)


@pytest.fixture(scope="module")
def model(reference_sd):
    m = tgen.Generator("hq")
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in reference_sd.items()}, strict=True)
    return m.eval()


def test_hq_soft_comp_matches_jax(rng):
    """Fold, then the 3x3 bias conv, at a size the base bias map cannot
    take."""
    b, t, c, hidden = 2, 2, 8, 32
    out_size = (30, 81)
    sc = {"embedding": {
        "w": (rng.standard_normal((hidden, 49 * c)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(49 * c) * 0.1).astype(np.float32)},
        "bias_conv": {
            "w": (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal(c) * 0.1).astype(np.float32)}}
    lh, lw = tfocal.token_grid(out_size)
    tok = rng.standard_normal((b, t, lh, lw, hidden)).astype(np.float32)
    want = np.asarray(jtf.soft_comp(jax.tree.map(jnp.asarray, sc),
                                    jnp.asarray(tok), t, out_size))
    tsc = tfocal.SoftComp(c, hidden)
    assert not hasattr(tsc, "bias")
    sd = from_jax._patch_linear_out(sc["embedding"], "embedding", c)
    sd.update(from_jax._conv(sc["bias_conv"], "bias_conv"))
    tsc.load_state_dict(from_jax.to_torch(sd), strict=True)
    with torch.no_grad():
        got = tfocal.soft_comp(tsc, torch.from_numpy(tok), t,
                               out_size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_hq_window_stage_matches_jax(reference_sd, model):
    """HQ at full width on 60x216 features: a 20x72 token grid, 32 windows,
    S = 141 deduplicated keys. B=2 end-padded windows (L=3 locals + 1 ref,
    T_pad 4); the first has 2 real locals and a padding frame."""
    params = convert_generator(reference_sd, "hq")
    _, _, s = tfocal._window_tables(20, 72, 5, 9, 2, 4, 4, 8, 4,
                                    torch.device("cpu"))
    assert s == 141
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 4, 60, 216, 128)).astype(np.float32)
    ff = (rng.standard_normal((2, 2, 60, 216, 2)) * 1.5).astype(np.float32)
    fb = (rng.standard_normal((2, 2, 60, 216, 2)) * 1.5).astype(np.float32)
    valid = np.array([2, 3], np.int32)
    fv = np.array([[1, 1, 0, 1], [1, 1, 1, 1]], np.bool_)
    want = np.asarray(jgen.window_stage(
        params, jnp.asarray(feat), (jnp.asarray(ff), jnp.asarray(fb)), 3,
        num_out=3, valid_local=jnp.asarray(valid),
        frame_valid=jnp.asarray(fv)))
    with torch.no_grad():
        got = tgen.window_stage(
            model, torch.from_numpy(feat),
            (torch.from_numpy(ff), torch.from_numpy(fb)), 3, num_out=3,
            valid_local=torch.from_numpy(valid),
            frame_valid=torch.from_numpy(fv)).numpy()
    assert got.shape == (2, 3, 240, 864, 3)
    for i, n in enumerate(valid):       # padded frames are discarded
        assert np.abs(got[i, :n] - want[i, :n]).max() < _bar(want[i, :n])


def test_hq_generator_matches_reference_golden(model):
    data = np.load(GOLDEN)
    t, lt = int(data["t"]), int(data["lt"])
    h, w = int(data["h"]), int(data["w"])
    frames = np.random.default_rng(11).uniform(
        -1, 1, (1, t, 3, h, w)).astype(np.float32)
    with torch.no_grad():
        out, (ff, fb) = tgen.generator_forward(
            model, torch.from_numpy(frames.transpose(0, 1, 3, 4, 2).copy()),
            lt)
    got = out.numpy().transpose(0, 3, 1, 2)[:, :, ::5, ::7]
    assert np.abs(got - data["out_slice"]).max() < _bar(data["out_slice"])
    for flow, key in ((ff, "flow_f_slice"), (fb, "flow_b_slice")):
        gf = flow.numpy().transpose(0, 1, 4, 2, 3)[:, :, :, ::3, ::3]
        assert (np.abs(gf - data[key]).max()
                < _bar(data["flow_f_slice"])), key


def test_decode_in_chunks_matches_one_pass(model, monkeypatch):
    """The decoder splits a batch whose full-resolution activation would
    pass 2^31 elements (CUDA's upsample limit; a 14-window batch at
    864x480); here the limit is lowered to 2 frames."""
    x = torch.randn((5, 6, 9, 128), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model.decode(x)
        monkeypatch.setattr(tgen, "DECODE_MAX_ELEMENTS", 64 * 16 * 6 * 9 * 2)
        got = model.decode(x)
    assert got.shape == (5, 24, 36, 3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_hq_round_trip_is_bit_exact(reference_sd):
    params = jax.tree.map(np.asarray, convert_generator(reference_sd, "hq"))
    back = from_jax.from_jax_params(params, "hq")
    assert sorted(back) == sorted(reference_sd)
    for k, v in reference_sd.items():
        assert back[k].shape == v.shape, k
        assert np.array_equal(back[k].numpy(), v), k
    with pytest.raises(ValueError, match="variant"):
        from_jax.from_jax_params(params, "large")


@pytest.mark.parametrize("ckpt, into", [("hq", "base"), ("base", "hq")])
def test_strict_load_refuses_other_variant(reference_sd, ckpt, into):
    if ckpt == "hq":
        sd = reference_sd
    else:
        sd = _golden_sd(GOLDEN.replace("_hq", "_base"))
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    with pytest.raises(RuntimeError, match="sc.bias"):
        tgen.load_reference_state_dict(tgen.Generator(into), sd)
    tgen.load_reference_state_dict(tgen.Generator(ckpt), sd)


def test_hq_init_weights():
    """Seeded init: the bias conv N(0, 0.02) with a zero bias, as the JAX
    package's _conv_init."""
    m = tgen.Generator("hq").init_weights(torch.Generator().manual_seed(0))
    conv = m.sc.bias_conv
    assert not conv.bias.any()
    assert abs(float(conv.weight.detach().std()) - 0.02) < 1e-3
    with pytest.raises(ValueError, match="variant"):
        tgen.Generator("large")


def _padded_video(t, h, w, seed=5):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)
    masks = np.zeros((t, h, w, 1), np.uint8)
    for i in range(t):
        masks[i, 20 + 3 * i: 60 + 3 * i, 40 + 5 * i: 110 + 5 * i] = 1
    return frames, masks


@pytest.mark.parametrize("pad_mod, padded", [((60, 108), (180, 216)),
                                             ((120, 216), (240, 216))])
def test_pipeline_at_padded_size(model, pad_mod, padded):
    """130x200 frames (not multiples of the pad) mirror-pad to `padded`:
    the composite comes back at 130x200, equal to the input outside the
    mask, and inside it equal to a run on the padded frames themselves,
    cropped."""
    frames, masks = _padded_video(6, 130, 200)
    runner = pipeline.SlidingWindowInpainter(
        model, max_batch=2, out_dtype=np.uint8, device="cpu",
        pad_mod=pad_mod)
    comp = np.stack(runner(frames, masks.astype(np.float32), frames, masks))
    assert comp.shape == frames.shape and comp.dtype == np.uint8
    outside = masks[..., 0] == 0
    np.testing.assert_array_equal(comp[outside], frames[outside])
    assert not np.array_equal(comp, frames)

    big, _ = pipeline.mirror_pad_hw(frames, *pad_mod)
    big_m, _ = pipeline.mirror_pad_hw(masks, *pad_mod)
    assert big.shape[1:3] == padded
    comp_big = np.stack(runner(big, big_m.astype(np.float32), big, big_m))
    np.testing.assert_array_equal(comp, comp_big[:, :130, :200])


def _args(**kw):
    base = dict(model="e2fgvi", set_size=False, width=None, height=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw, want", [
    (dict(), (432, 240)),
    (dict(set_size=True, width=216, height=120), (432, 240)),
    (dict(model="e2fgvi_hq", set_size=True, width=216, height=120),
     (216, 120)),
    (dict(model="e2fgvi_hq", width=216, height=120), None)])
def test_inpaint_frame_size(kw, want):
    """Base is always 432x240; HQ takes --width/--height only with
    --set_size, else the video's own size (None)."""
    assert inpaint.frame_size(_args(**kw)) == want


def test_inpaint_cli_hq_set_size(tmp_path, reference_sd):
    """--model e2fgvi_hq --set_size 216x120 on examples/hqtest (864x480)
    with a reference-layout HQ .pth."""
    from e2fgvi_tpu.data import readers
    sd = {k: torch.from_numpy(v) for k, v in reference_sd.items()}
    sd["update_spynet.std"] = torch.ones(1, 3, 1, 1)
    ckpt = tmp_path / "E2FGVI-HQ-CVPR22.pth"
    torch.save(sd, ckpt)
    video = os.path.join(ROOT, "examples", "hqtest")
    assert readers.read_frames(video, None)[0].size == (864, 480)
    out = inpaint.main([
        "-v", video, "-m", os.path.join(ROOT, "examples", "hqtest_mask"),
        "-c", str(ckpt), "--model", "e2fgvi_hq", "--set_size",
        "--width", "216", "--height", "120", "--device", "cpu",
        "--max_batch", "2", "--out", str(tmp_path / "results"),
        "--no_show"])
    frames = readers.read_frames(out, None)
    assert len(frames) == 10 and frames[0].size == (216, 120)
