"""The check that decides `correct`, driven through a whole run at a size
the CPU holds (HQ at 108x60, videos of 7 and 13 frames, bf16, the HQ
cell's limits): sound, it passes; with the control (the reference in fp8
in the program's place) or with the timed path broken underneath, it
fails. The float32 cell's control (TF32) exists only on the card."""

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

import run as run_mod  # noqa: E402
from harness import check, common  # noqa: E402


TINY = {"height": 60, "width": 108, "lengths": [7, 13], "check_videos": 2}


def tiny_cell(name="hq_bf16_davis480"):
    c = common.cell(name)
    c["traffic"] = dict(c["traffic"], **TINY)
    return c


def correct(cell, seed=987654321012, program_cls=None):
    out, _ = run_mod.execute(cell, seed, 0.5, False, torch.device("cpu"),
                             common.Clock(), program_cls=program_cls)
    assert set(out["compared"]) == {"worst_frame_mae", "outside_mask_diff"}
    return out["correct"], out["compared"]


def test_sound_run_is_correct():
    ok, comp = correct(tiny_cell())
    assert ok, comp


def test_control_is_not_correct():
    ok, comp = correct(tiny_cell(), program_cls=check.ReferenceProgram)
    assert not ok, comp
    assert comp["worst_frame_mae"]["value"] > \
        comp["worst_frame_mae"]["limit"]


def _block_unchanged(block, x, *a, **k):
    return x


def _half_batch(orig):
    def stage(model, feat, flows, n_local, **k):
        out = orig(model, feat, flows, n_local, **k)
        half = (out.shape[0] + 1) // 2
        return torch.cat([out[:half], out[:out.shape[0] - half]])
    return stage


def _one_frame_altered(orig):
    def stage(model, feat, flows, n_local, **k):
        out = orig(model, feat, flows, n_local, **k).clone()
        out[0, 0] = out[0, 0].flip(-1)          # its colours as BGR
        return out
    return stage


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_broken_path_is_not_correct(fault, monkeypatch):
    """A transformer block that returns its state unchanged; half of a
    window batch left out (the other half's outputs in its place); one
    frame of one window's output altered where it is produced (its
    channels in BGR order). One card holds the cell, so no exchange
    between chips exists to leave out."""
    from e2fgvi_tpu_torch.models import e2fgvi, tfocal
    if fault == "state_unchanged":
        monkeypatch.setattr(tfocal, "transformer_block", _block_unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(e2fgvi, "window_stage",
                            _half_batch(e2fgvi.window_stage))
    else:
        monkeypatch.setattr(e2fgvi, "window_stage",
                            _one_frame_altered(e2fgvi.window_stage))
    ok, comp = correct(tiny_cell())
    assert not ok, comp


@pytest.mark.cuda
def test_f32_control_fails_on_the_card():
    """TF32 in the float32 cell's place, at the cell's own size, on three
    seeds: the reading passes the limit on each."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    import calibrate
    cell = common.cell("base_f32_davis")
    limit = cell["check"]["limits"]["worst_frame_mae"]
    for seed in (5, 6, 7):
        r = calibrate.readings(cell, seed, torch.device("cuda:0"), True,
                               False)
        assert r["control"][0] > limit, r
