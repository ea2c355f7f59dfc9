"""The propainter cell's own files and BENCHMARK.json entries: the cell
resolves with its three compared numbers, the config is the reference's,
the entries keep the benchmark's rules, the work counts what the masks
decide, the traffic's masks are the ellipse the mix describes, and on the
CPU at a small size a sound run is correct while the fp8 control and a
broken sparse attention are not; on the card, RAFT in TF32 in the
program's place is not correct through the run's own comparison."""

import functools
import os
import re
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

import run as run_mod  # noqa: E402
from harness import common, work_propainter  # noqa: E402
from reference import propainter as ref  # noqa: E402

CELL = "propainter_bf16_davis480"
BENCH_P = common.benchmark()
TINY = {"height": 128, "width": 128, "lengths": [7, 9], "check_videos": 2,
        "mask": {"semi_axes": [30, 20], "step": [4, 2]}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PER_LAYER = [f"stage_ms_per_frame.{s}.propainter" for s in (
    "flows", "img_prop", "encode", "feat_prop", "transformer", "decode")] + [
    "k1_roofline.propainter", "k3_roofline.propainter",
    "mfu.serve.propainter", "device_idle_pct.serve.propainter",
    "peak_gib.serve.propainter", "host_syncs_per_video.propainter"]


def test_cell_resolves():
    c = common.cell(CELL, BENCH_P)
    assert set(c["check"]["limits"]) == {"worst_frame_mae",
                                         "outside_mask_diff",
                                         "worst_flow_epe"}
    assert c["check"]["limits"]["outside_mask_diff"] == 0
    cfg = c["config"]
    assert (cfg["channel"], cfg["hidden"], cfg["depths"], cfg["num_heads"]) \
        == (ref.CHANNEL, ref.HIDDEN, ref.DEPTHS, ref.NUM_HEADS)
    assert tuple(cfg["window_size"]) == ref.WINDOW
    assert tuple(cfg["pool_size"]) == ref.POOL
    assert cfg["d_ff"] == ref.D_FF
    assert cfg["deform_groups"] == ref.DEFORM_GROUPS
    assert cfg["max_residue_magnitude"] == ref.MAX_RESIDUE
    assert cfg["raft"]["iters"] == ref.RAFT_ITERS
    assert cfg["subvideo_length"] == ref.SUBVIDEO
    entry = [x for x in BENCH_P["configs"] if x["name"] == "propainter"][0]
    assert cfg["reduced"] == entry["reduced"]
    for traced in (False, True):
        names = [n for n, _ in common.metrics_for(CELL, traced, BENCH_P)]
        assert names
        for n in names:
            assert callable(common.reader(n).read)
    assert [n for n, _ in common.metrics_for(CELL, False, BENCH_P)] == [
        "frames_per_s.hq", "setup_s"]
    assert [n for n, _ in common.metrics_for(CELL, True, BENCH_P)] == \
        PER_LAYER


def test_entries_keep_the_benchmarks_rules():
    """The cell's entries are the last of their lists; names, units and
    whys keep the benchmark's rules; every per-layer metric of the cell
    moves frames_per_s.hq, which the cell reports, and names a layer of
    the benchmark's."""
    config, workload = BENCH_P["configs"][-1], BENCH_P["workloads"][-1]
    assert config["name"] == "propainter" and workload["name"] == CELL
    assert workload["config"] == "propainter" and workload["chips"] == 1
    for x in (config, workload):
        assert NAME.match(x["name"]) and 1 <= len(x["why"]) <= 200
        assert "\n" not in x["why"]
    assert all(NAME.match(k) for k in config["reduced"])
    assert 1 <= len(config["source"]) <= 200
    e2e = {m["name"]: m for m in BENCH_P["end_to_end"]}
    assert e2e["frames_per_s.hq"]["workloads"][-1] == CELL
    assert [n for n, m in e2e.items() if CELL in m.get("workloads", [CELL])] \
        == ["frames_per_s.hq", "setup_s"]
    mine = [m for m in BENCH_P["per_layer"] if CELL in m["workloads"]]
    assert [m["name"] for m in mine] == PER_LAYER
    assert BENCH_P["per_layer"][-len(mine):] == mine
    names = [m["name"] for g in ("end_to_end", "per_layer")
             for m in BENCH_P[g]]
    assert len(names) == len(set(names))
    layers = {m["layer"] for m in BENCH_P["per_layer"]} | {"img_prop"}
    for m in mine:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["workloads"] == [CELL] and m["moves"] == "frames_per_s.hq"
        assert m["layer"] in layers


def test_work_counts_the_flagged_windows():
    """The work's window flags are the program's (models/propainter.py),
    and a flagged window's keys a frame are 45 own + 148 rolled + 180
    pooled at 848x480."""
    from e2fgvi_tpu_torch.models import propainter
    assert work_propainter.key_count(40, 72) == 373
    kind = common.traffic_kind("serve_propainter")
    tr = dict(common.cell(CELL, BENCH_P)["traffic"], lengths=[25])
    _, masks = kind.make_videos(tr, 31415926535, torch.device("cpu"))[0]
    got = work_propainter.flags(masks)
    want = propainter.window_flags(masks[:, ::4, ::4, 0], 40, 71)
    assert np.array_equal(got, want)
    share = got.mean()
    assert 0.15 < share < 0.5, share
    w = work_propainter.video_work(masks, 2, 14)
    assert 0 < w["k3_flops"] < w["model_flops"]
    assert 0 < w["k1_flops"] < w["model_flops"]


def test_ellipse_masks_move_and_bounce():
    kind = common.traffic_kind("serve_propainter")
    m = kind.ellipse_masks(np.random.default_rng(0), 200, 480, 848,
                           (150, 100), (4, 2))
    area = m[..., 0].mean((1, 2))
    assert np.allclose(area, np.pi * 150 * 100 / (480 * 848), rtol=0.01)
    ys, xs = np.nonzero(m[0, ..., 0])
    ys2, xs2 = np.nonzero(m[1, ..., 0])
    assert abs(abs(xs2.mean() - xs.mean()) - 4) < 0.5
    assert abs(abs(ys2.mean() - ys.mean()) - 2) < 0.5


def _tiny_cell():
    c = common.cell(CELL, BENCH_P)
    c["traffic"] = dict(c["traffic"], **TINY)
    return c


def _correct(cell, program_cls=None, device="cpu"):
    kw = {} if program_cls is None else {"program_cls": program_cls}
    out, _ = run_mod.execute(cell, 98765432101234, 0.5, False,
                             torch.device(device), common.Clock(), BENCH_P,
                             **kw)
    return out["correct"], out["compared"]


def test_sound_run_is_correct():
    ok, comp = _correct(_tiny_cell())
    assert ok, comp


def test_controls_are_not_correct():
    """The reference in fp8 in the program's place fails worst_frame_mae;
    a sparse attention whose flagged rows attend inside their own frame
    only fails too."""
    kind = common.traffic_kind("serve_propainter")
    ok, comp = _correct(_tiny_cell(), kind.ReferenceProgram)
    assert not ok
    assert comp["worst_frame_mae"]["value"] > comp["worst_frame_mae"][
        "limit"], comp


def test_frame_only_attention_is_not_correct(monkeypatch):
    from e2fgvi_tpu_torch.models import propainter
    orig = propainter.sparse_attention

    def frame_only(attn, x, rows, parity, **k):
        rows = propainter.SparseRows(
            rows.flagged[:0], torch.sort(torch.cat([rows.flagged,
                                                    rows.frame]))[0],
            rows.key_frames, rows.key_valid)
        return orig(attn, x, rows, parity, **k)
    monkeypatch.setattr(propainter, "sparse_attention", frame_only)
    ok, comp = _correct(_tiny_cell())
    assert not ok, comp


@pytest.mark.cuda
def test_flow_control_fails_on_the_card():
    """The reference with RAFT (and the generator) in TF32 in the
    program's place, through a run at the cell's frame size on two short
    videos: its flows, kept by the run as the program's are, fail
    worst_flow_epe, and the run is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    kind = common.traffic_kind("serve_propainter")
    c = common.cell(CELL, BENCH_P)
    c["traffic"] = dict(c["traffic"], lengths=[6, 8], check_videos=2)
    ok, comp = _correct(c, functools.partial(kind.ReferenceProgram,
                                             precision="tf32"), "cuda:0")
    assert not ok
    epe = comp["worst_flow_epe"]
    assert epe["limit"] < epe["value"] < float("inf"), comp
