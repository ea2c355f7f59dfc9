"""The vace cell's own files and BENCHMARK.json entries: the cell resolves
with its three compared numbers, the configuration is the published one
and agrees with the benchmark's entry and the reference, the entries keep
the benchmark's rules, the work counts the published shapes, and on the
CPU at a tiny size a sound run is correct while the fp8 control and the
three faults the limits must refuse (no context branch, no RoPE, the
modulation's float32 dropped) are not."""

import os
import re
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

import calibrate_wan_vace as cal  # noqa: E402
import run as run_mod  # noqa: E402
from harness import common, work_wan_vace  # noqa: E402
from reference import wan_vace as ref  # noqa: E402

CELL = "vace_bf16_objmask480"
BENCH_P = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PER_LAYER = [f"stage_ms_per_frame.{s}.vace" for s in (
    "prep", "vae_encode", "dit", "dit_context", "vae_decode", "blend",
    "fetch")] + ["dit_attn_roofline.vace", "mfu.serve.vace",
                 "device_idle_pct.serve.vace", "peak_gib.serve.vace",
                 "host_syncs_per_video.vace", "dit_forwards_per_video.vace"]
TINY_DIT = dict(dim=64, ffn_dim=128, freq_dim=32, text_dim=32, text_len=16,
                num_heads=2, num_layers=4, vace_layers=[0, 2])
TINY_TRAFFIC = dict(height=64, width=96, lengths=[9, 9], check_videos=2,
                    mask={"semi_axes": [20, 14], "step": [4, 2]})


def test_cell_resolves():
    c = common.cell(CELL, BENCH_P)
    assert set(c["check"]["limits"]) == {"worst_frame_mae",
                                         "outside_mask_diff",
                                         "worst_velocity_rel"}
    assert c["check"]["limits"]["outside_mask_diff"] == 0
    cfg = c["config"]
    d, v = cfg["dit"], cfg["vae"]
    assert (d["dim"], d["ffn_dim"], d["num_heads"], d["num_layers"],
            d["freq_dim"], d["text_len"], d["text_dim"], d["in_dim"],
            d["out_dim"], d["vace_in_dim"]) == (1536, 8960, 12, 30, 256,
                                                512, 4096, 16, 16, 96)
    assert d["vace_layers"] == list(range(0, 30, 2))
    assert d["patch_size"] == [1, 2, 2] and d["qk_norm"] and \
        d["cross_attn_norm"]
    assert (v["dim"], v["z_dim"], v["dim_mult"], v["num_res_blocks"],
            v["temperal_downsample"]) == (96, 16, [1, 2, 4, 4], 2,
                                          [False, True, True])
    assert cfg["sample_steps"] == 4
    entry = [x for x in BENCH_P["configs"] if x["name"] == "wan_vace_1.3b"][0]
    assert cfg["reduced"] == entry["reduced"] == ["text_encoder_umT5",
                                                  "sample_steps"]
    assert set(cfg["reduced_why"]) == set(cfg["reduced"])
    for traced in (False, True):
        for n, _ in common.metrics_for(CELL, traced, BENCH_P):
            assert callable(common.reader(n).read)
    assert [n for n, _ in common.metrics_for(CELL, False, BENCH_P)] == [
        "frames_per_s.hq", "setup_s"]
    assert [n for n, _ in common.metrics_for(CELL, True, BENCH_P)] == \
        PER_LAYER
    # the configuration's widths are the reference's parameter shapes
    kind = common.traffic_kind("serve_wan_vace")
    shapes = dict(ref.param_shapes(kind.model_config(cfg))["dit"])
    assert shapes["blocks.29.ffn.0.weight"] == (8960, 1536)
    assert shapes["vace_blocks.14.after_proj.weight"] == (1536, 1536)
    assert "vace_blocks.1.before_proj.weight" not in shapes


def test_entries_keep_the_benchmarks_rules():
    """The cell's entries are the last of their lists; names, units and
    whys keep the benchmark's rules; every per-layer metric of the cell
    moves frames_per_s.hq and lists only this cell."""
    config, workload = BENCH_P["configs"][-1], BENCH_P["workloads"][-1]
    assert config["name"] == "wan_vace_1.3b" and workload["name"] == CELL
    assert workload["config"] == "wan_vace_1.3b" and workload["chips"] == 1
    assert workload["traffic"] == "objmask480_vace_bf16_81f"
    for x in (config, workload):
        assert NAME.match(x["name"]) and 1 <= len(x["why"]) <= 200
        assert "\n" not in x["why"]
    assert all(NAME.match(k) for k in config["reduced"])
    assert 1 <= len(config["source"]) <= 200
    e2e = {m["name"]: m for m in BENCH_P["end_to_end"]}
    assert e2e["frames_per_s.hq"]["workloads"][-1] == CELL
    mine = [m for m in BENCH_P["per_layer"] if CELL in m["workloads"]]
    assert [m["name"] for m in mine] == PER_LAYER
    assert BENCH_P["per_layer"][-len(mine):] == mine
    names = [m["name"] for g in ("end_to_end", "per_layer")
             for m in BENCH_P[g]]
    assert len(names) == len(set(names))
    for m in mine:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["workloads"] == [CELL] and m["moves"] == "frames_per_s.hq"
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(open(os.path.join(ROOT, "BENCHMARK.json")).read()) < 65536


def test_work_at_the_published_shapes():
    """S = 21 x 30 x 52 = 32,760; a self-attention call is 4 S^2 dim (6.6
    TFLOP), about 70% of the DiT's operations; a video is 8 forwards."""
    cfg = common.cell(CELL, BENCH_P)["config"]
    mc = common.traffic_kind("serve_wan_vace").model_config(cfg)
    s = work_wan_vace.tokens(mc["dit"], 81, 480, 832)
    assert s == 32760
    fwd = work_wan_vace.dit_forward_flops(mc["dit"], s)
    assert 4.0e14 < fwd < 4.4e14
    w = work_wan_vace.video_work(mc, 81, 480, 832, 4, 2)
    assert w["dit_attn_flops"] == 8 * 45 * 4 * s * s * 1536
    assert 0.65 < w["dit_attn_flops"] / (8 * fwd) < 0.75
    assert w["model_flops"] > 8 * fwd


def _tiny_cell():
    c = common.cell(CELL, BENCH_P)
    c["config"]["dit"].update(TINY_DIT)
    c["config"]["vae"]["dim"] = 8
    c["config"]["prompt_tokens"] = [4, 6]
    c["traffic"].update(TINY_TRAFFIC)
    return c


def _correct(cell, program_cls=None):
    kw = {} if program_cls is None else {"program_cls": program_cls}
    out, _ = run_mod.execute(cell, 98765432101234, 0.5, False,
                             torch.device("cpu"), common.Clock(), BENCH_P,
                             **kw)
    return out["correct"], out["compared"]


def test_sound_run_is_correct():
    ok, comp = _correct(_tiny_cell())
    assert ok, comp


def test_control_is_not_correct():
    """The reference in fp8 in the program's place fails both the frames'
    and the velocity's limit."""
    kind = common.traffic_kind("serve_wan_vace")
    ok, comp = _correct(_tiny_cell(), kind.ControlProgram)
    assert not ok
    for name in ("worst_frame_mae", "worst_velocity_rel"):
        assert comp[name]["value"] > comp[name]["limit"], comp


@pytest.mark.parametrize("fault", ["no_hints", "no_rope", "bf16_modulation"])
def test_faults_are_not_correct(fault):
    """A bfloat16 program without the context branch, without RoPE, or
    without the modulation's float32 reads past the velocity's limit at
    steps 0-2 (whose timesteps bfloat16 does not hold)."""
    cell = _tiny_cell()
    kind = common.traffic_kind("serve_wan_vace")
    cpu = torch.device("cpu")
    seed = 98765432101234
    prog = kind.Program(cell, seed, cpu)
    frames, masks = kind.make_videos(cell["traffic"], seed, cpu)[0]
    prog(frames, masks, keep_step=1)
    kept = prog.kept()
    refs = kind.reference_models(cell["config"], seed, cpu)
    want = kind.reference_velocity(refs, cell["config"], kept)
    limit = cell["check"]["limits"]["worst_velocity_rel"]
    assert kind.velocity_rel(kept["velocity"], want) < limit
    with cal.fault(prog.model, fault):
        got = cal.guided(prog.model, kept)
    assert kind.velocity_rel(got, want) > limit
