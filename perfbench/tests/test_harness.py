"""The harness's own arithmetic and discovery: cells, configs, mixes and
metrics are found by name; BENCHMARK.json agrees with the files; a new
cell is files plus entries; the percentile is over all videos; idle share
is a union of intervals; no run may hold JAX."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

from harness import common, trace  # noqa: E402
from reference import model as ref_model  # noqa: E402


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return common.benchmark()


def test_every_cell_resolves(bench):
    """Each workload names a config, a traffic mix whose kind has a
    generator, limits for the numbers it compares, and metric readers for
    every metric it reports."""
    for w in bench["workloads"]:
        c = common.cell(w["name"], bench)
        assert os.path.exists(os.path.join(
            BENCH, "traffic", c["traffic"]["kind"] + ".py"))
        assert set(c["check"]["limits"]) == {"worst_frame_mae",
                                             "outside_mask_diff"}
        assert c["check"]["limits"]["outside_mask_diff"] == 0
        for traced in (False, True):
            names = [n for n, _ in common.metrics_for(w["name"], traced,
                                                      bench)]
            assert names
            for n in names:
                assert callable(common.reader(n).read)
        assert "setup_s" in [n for n, _ in common.metrics_for(
            w["name"], False, bench)]


def test_benchmark_json_agrees_with_the_files(bench):
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cfg_names = {c["name"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == cfg_names
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = common.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] == []
        # the file holds the configuration as the reference runs it
        assert cfg["hidden"] == ref_model.HIDDEN
        assert cfg["channel"] == ref_model.CHANNEL
        assert cfg["depths"] == ref_model.DEPTHS
        assert cfg["num_heads"] == ref_model.NUM_HEADS
        assert tuple(cfg["window_size"]) == ref_model.WINDOW
        assert cfg["d_ff"] == ref_model.D_FF
        assert cfg["deform_groups"] == ref_model.DEFORM_GROUPS
    metric_names = set()
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in metric_names
            metric_names.add(m["name"])
            assert callable(common.reader(m["name"]).read)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        spec = common.load_json(os.path.join(BENCH, "workloads",
                                             w["name"] + ".json"))
        assert (spec["config"], spec["traffic"]) == (w["config"],
                                                     w["traffic"])


def test_serving_lengths_are_davis_quantiles(bench):
    """Each serving mix's pool is the DAVIS test set's lengths (the
    reference's manifest, 50 videos) at the quantiles i / (n - 1), so the
    shortest and the longest are in every pool."""
    davis = sorted(common.load_json(os.path.join(
        ROOT, "datasets", "davis", "test.json")).values())
    for w in bench["workloads"]:
        tr = common.cell(w["name"], bench)["traffic"]
        n = len(tr["lengths"])
        assert tr["lengths"] == [davis[round(i * (len(davis) - 1) / (n - 1))]
                                 for i in range(n)]


def test_a_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix and a metric by
    new files and new BENCHMARK.json entries alone, and runs the new cell
    (on the CPU, at a size it holds) without a change to any file that was
    there."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    before = {p: open(p, "rb").read()
              for p in map(str, (tmp_path / "perfbench").rglob("*.*"))}
    (tmp_path / "perfbench/traffic/tiny_hq.json").write_text(json.dumps({
        "kind": "serve_videos", "dtype": "bfloat16", "max_batch": 14,
        "height": 60, "width": 108,
        "lengths": [7, 9], "out_dtype": "uint8", "check_videos": 1}))
    (tmp_path / "perfbench/workloads/hq_tiny.json").write_text(json.dumps({
        "config": "e2fgvi_hq", "traffic": "tiny_hq",
        "check": {"control": "float8_e4m3fn",
                  "limits": {"worst_frame_mae": 1e9,
                             "outside_mask_diff": 0}}}))
    (tmp_path / "perfbench/metrics/videos_per_s.py").write_text(
        "def read(run):\n    return len(run['latencies']) / run['window_s']\n")
    b["workloads"].append({"name": "hq_tiny", "config": "e2fgvi_hq",
                           "traffic": "tiny_hq", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "videos_per_s", "unit": "videos/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["hq_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'perfbench')!r},"
        f" {ROOT!r}]\n"
        "import run\n"
        "from harness import common\n"
        "c = common.cell('hq_tiny')\n"
        "out, _ = run.execute(c, 3, 0.1, False, torch.device('cpu'),"
        " common.Clock())\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "videos_per_s"}
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_percentile_is_over_all_videos():
    lat = [1.0] * 89 + [2.0] * 10 + [100.0]
    assert common.percentile(lat, 90) == pytest.approx(2.0)
    assert common.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)
    assert common.percentile([5.0], 90) == 5.0
    # the reader sees every latency of the window, not medians of chunks
    reader = common.reader("video_latency_p90_s")
    run = {"kind": "serve", "latencies": lat}
    assert reader.read(run) == common.percentile(lat, 90)


def test_idle_share_is_a_union_of_intervals():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    us = 1e6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 10 * us, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 1 * us,
         "dur": 3 * us, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 2 * us,
         "dur": 4 * us, "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 9 * us,
         "dur": 3 * us, "args": {}},
        {"ph": "X", "cat": "user_annotation", "name": "r", "ts": 0.5 * us,
         "dur": 0.2 * us, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0.6 * us, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 6 * us,
         "dur": 3 * us, "tid": 1},
    ]
    s = trace.summarize(events, ranges=("r", "absent"))
    assert s["window_s"] == pytest.approx(10)
    assert s["busy_s"] == pytest.approx(5 + 1)      # [1, 6) and [9, 10)
    assert s["range_s"] == {"r": pytest.approx(4), "absent": None}
    assert s["idle_gaps"][0] == ["aten::copy_", pytest.approx(3)]
    assert s["device_ops"][0] == ["b", pytest.approx(4)]


def test_banned_modules_compare_top_level_names_whole():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib": 1, "flax.core": 1,
            "e2fgvi_tpu.models": 1, "e2fgvi_tpu_torch": 1,
            "e2fgvi_tpu_torch.models": 1, "jaxtyping": 1}
    assert common.banned_modules(mods) == ["e2fgvi_tpu.models", "flax.core",
                                           "jax", "jax.numpy", "jaxlib"]


def test_run_imports_no_jax():
    """A run's harness, reference and the port's serving path load no
    module of JAX or of the JAX package."""
    code = ("import sys\n"
            f"sys.path[:0] = [{ROOT!r}, {BENCH!r}]\n"
            "import run, calibrate\n"
            "from harness import common, check, trace, work\n"
            "import e2fgvi_tpu_torch.data.pipeline\n"
            "import e2fgvi_tpu_torch.models.e2fgvi\n"
            "import e2fgvi_tpu_torch.utils.timing\n"
            "common.traffic_kind('serve_videos')\n"
            "print(common.banned_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


def test_no_cuda_means_no_result():
    """Without CUDA the run exits nonzero and prints no result line."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.path[:0] = [{ROOT!r}, {BENCH!r}]\n"
            "import run\n"
            "sys.exit(run.main(['--workload', 'base_bf16_davis', '--seed',"
            " '1', '--seconds', '1']))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
