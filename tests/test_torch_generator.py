"""The port's serving slice as a whole: window_stage against the JAX
package, the generator against the reference golden, the pipeline's host
tables against the JAX pipeline's, the protocol golden (slow tier), the
port's independence from JAX, and a call's spans and counters under
utils/timing.StageTimer."""

import ast
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.convert.torch_loader import convert_generator
from e2fgvi_tpu.data import pipeline as jpipe
from e2fgvi_tpu.models import e2fgvi as jgen
from e2fgvi_tpu_torch.data import pipeline
from e2fgvi_tpu_torch.models import e2fgvi as tgen
from e2fgvi_tpu_torch.utils import env, timing
from test_generator_golden import fill_weight
from test_torch_utils import FakeCuda

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")


def _bar(want):
    return 2e-3 * np.abs(want).max() + 2e-5


@pytest.fixture(scope="module")
def reference_sd():
    data = np.load(os.path.join(GOLDENS, "generator_base.npz"))
    keys = [str(k) for k in data["keys"]]
    shapes = [ast.literal_eval(str(s)) for s in data["shapes"]]
    rng = np.random.default_rng(7)
    return {k: fill_weight(k, s, rng) for k, s in zip(keys, shapes)}


@pytest.fixture(scope="module")
def model(reference_sd):
    m = tgen.Generator()
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in reference_sd.items()}, strict=True)
    return m.eval()


def test_window_stage_matches_jax(reference_sd, model):
    """Base model at full width on 60x108 features: B=2 end-padded windows
    (L=3 locals + 1 ref, T_pad 4); the first has 2 real locals."""
    params = convert_generator(reference_sd, "base")
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 4, 60, 108, 128)).astype(np.float32)
    ff = (rng.standard_normal((2, 2, 60, 108, 2)) * 1.5).astype(np.float32)
    fb = (rng.standard_normal((2, 2, 60, 108, 2)) * 1.5).astype(np.float32)
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
    for i, n in enumerate(valid):       # padded frames are discarded
        assert np.abs(got[i, :n] - want[i, :n]).max() < _bar(want[i, :n])


def test_generator_matches_reference_golden(model):
    data = np.load(os.path.join(GOLDENS, "generator_base.npz"))
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


def _jax_tables(video_length, num_ref, ref_length=10):
    """Run the JAX pipeline's host logic with its device programs replaced
    by fakes that record the window and blend tables they are given."""
    runner = jpipe.SlidingWindowInpainter(
        {}, max_batch=64, pad_mod=(2, 2), ref_length=ref_length,
        num_ref=num_ref)
    seen = {"window": []}

    def encode(params, fch, packed, hw):
        n = fch.shape[0]
        return jnp.zeros((n, 1, 1, 1)), jnp.zeros((n, 1, 1, 3))

    def flows(params, small_all, pidx):
        z = jnp.zeros((pidx.shape[0], 1, 1, 2))
        return z, z

    def window(params, feat_all, ff, fb, idx, bw, fw, val, fval, n_local,
               band):
        seen["window"].append([np.asarray(a)
                               for a in (idx, bw, fw, val, fval)])
        seen["n_local"] = n_local
        b = idx.shape[0]
        return jnp.zeros((b, n_local, 2, 2, 3), jnp.uint8), jnp.float32(0)

    def assemble(preds, bits, idx_tab, wt_tab, geom):
        seen["blend"] = (np.asarray(idx_tab), np.asarray(wt_tab))
        return jnp.zeros((geom[0], 3), jnp.float16)

    runner._encode_jit, runner._flow_jit = encode, flows
    runner._window_jit, runner._assemble_jit = window, assemble
    frames = np.zeros((video_length, 2, 2, 3), np.uint8)
    masks = np.zeros((video_length, 2, 2, 1), np.float32)
    runner(frames, masks, frames, masks.astype(np.uint8))
    return seen


@pytest.mark.parametrize("num_ref", [-1, 2, 3])
def test_pipeline_tables_match_jax(num_ref):
    """plan_windows / ref_ids (with the num_ref off-by-one), the end-padding
    tables and the blend tables, for video lengths 1-40."""
    for length in range(1, 41):
        for f in range(0, length, 5):
            nb = pipeline.neighbor_ids(f, length)
            assert nb == jpipe.neighbor_ids(f, length)
            assert (pipeline.ref_ids(f, nb, length, 4, num_ref)
                    == jpipe.ref_ids(f, nb, length, 4, num_ref))
        plans = pipeline.plan_windows(length, 5, 4, num_ref)
        jplans = jpipe.plan_windows(length, 5, 4, num_ref)
        assert [(p.pivot, p.neighbors, p.refs) for p in plans] == \
            [(p.pivot, p.neighbors, p.refs) for p in jplans]

        seen = _jax_tables(length, num_ref, ref_length=4)
        n_local, *tables = pipeline.padding_tables(plans)
        assert n_local == seen["n_local"]
        # the JAX pipeline ran the windows in chunks, the last one padded
        # by repeating rows; its prediction rows count the padding too
        chunks = seen["window"]
        for i, got in enumerate(tables):
            want = np.concatenate([c[i] for c in chunks])[:len(plans)]
            np.testing.assert_array_equal(got, want)
        mb = chunks[0][0].shape[0]
        pred_row = {(wi, li): (wi // mb) * mb * n_local
                    + (wi % mb) * n_local + li
                    for wi, p in enumerate(plans)
                    for li in range(len(p.neighbors))}
        idx, wt = pipeline.blend_tables(plans, pred_row, length)
        widx, wwt = seen["blend"]
        np.testing.assert_array_equal(idx, widx[:length])
        np.testing.assert_array_equal(wt, wwt[:length])


@pytest.mark.parametrize("shape", [(3, 240, 432, 3), (2, 250, 400, 3),
                                   (1, 61, 109, 1), (2, 7, 5, 3)])
def test_mirror_pad_matches_jax(rng, shape):
    x = rng.integers(0, 256, shape).astype(np.uint8)
    got, hw = pipeline.mirror_pad_hw(x)
    want, whw = jpipe.mirror_pad_hw(x)
    assert hw == whw
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_protocol_matches_reference_golden(model):
    """The port's SlidingWindowInpainter + eval.metrics against
    tests/goldens/protocol_base.npz, at tests/test_protocol_golden.py's
    bars."""
    from e2fgvi_tpu.data.masks import dilate_cross
    from e2fgvi_tpu.eval import metrics
    from test_protocol_golden import synth_video

    data = np.load(os.path.join(GOLDENS, "protocol_base.npz"))
    t, h, w = int(data["t"]), int(data["h"]), int(data["w"])
    frames_u8, masks_bin = synth_video(t, h, w)
    masks_dil = np.stack([dilate_cross(m) for m in masks_bin])[..., None]
    runner = pipeline.SlidingWindowInpainter(
        model, max_batch=4, dtype=torch.float32, out_dtype=np.float32,
        device="cpu")
    comp = np.stack(runner(frames_u8, masks_dil.astype(np.float32),
                           frames_u8, masks_dil.astype(np.uint8)))
    diff = np.abs(comp[:, ::4, ::6, :] - data["comp_slice"])
    assert diff.max() <= 1.0 + 1e-5, diff.max()
    assert (diff > 0.5).mean() < 5e-3, (diff > 0.5).mean()
    psnr, ssim = zip(*(metrics.calc_psnr_and_ssim(o.astype(np.float64),
                                                  c.astype(np.float64))
                       for o, c in zip(frames_u8, comp)))
    np.testing.assert_allclose(psnr, data["psnr"], atol=0.02)
    np.testing.assert_allclose(ssim, data["ssim"], atol=2e-4)


_BLOCKED = ("jax", "e2fgvi_tpu")
# run in a fresh interpreter with jax and the JAX package unimportable;
# each case ends by checking that neither was loaded
_NO_JAX_CASES = {
    "modules": (
        "import pkgutil, importlib\n"
        "import e2fgvi_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'e2fgvi_tpu_torch.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"),
    "inpaint": (
        "from e2fgvi_tpu_torch.cli import inpaint\n"
        "out = inpaint.main(['-v', 'examples/mini', '-m', "
        "'examples/mini_mask', '-c', 'none', '--random_weights', "
        "'--model', 'e2fgvi_hq', '--set_size', '--width', '108', "
        "'--height', '60', '--device', 'cpu', '--out', TMP, "
        "'--no_show'])\n"
        "import os\n"
        "print(os.path.getsize(out))\n"),
    "evaluate": (
        "import os\n"
        "from chip_smoke import write_davis\n"
        "from e2fgvi_tpu_torch.cli import evaluate\n"
        "write_davis(TMP, 1, 6, 120, 216)\n"
        "psnr, ssim, vfid = evaluate.main(['--dataset', 'davis', "
        "'--data_root', TMP, '--ckpt', 'none', '--random_weights', "
        "'--model', 'e2fgvi_hq', '--width', '216', '--height', '120', "
        "'--i3d_ckpt', os.path.join(TMP, 'absent.pt'), '--device', 'cpu', "
        "'--out', os.path.join(TMP, 'results')])\n"
        "print(int(psnr > 0 and 0 < ssim <= 1))\n"),
    "train": (
        "import json, os, zipfile\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "from e2fgvi_tpu_torch.train import trainer\n"
        "root = os.path.join(TMP, 'vos')\n"
        "os.makedirs(os.path.join(root, 'JPEGImages'))\n"
        "rng = np.random.default_rng(0)\n"
        "with zipfile.ZipFile(os.path.join(root, 'JPEGImages', 'v.zip'), "
        "'w') as zf:\n"
        "    for i in range(6):\n"
        "        p = os.path.join(TMP, 'f.jpg')\n"
        "        Image.fromarray(rng.integers(0, 255, (120, 216, 3), "
        "dtype=np.uint8)).save(p)\n"
        "        zf.write(p, arcname=f'{i:05d}.jpg')\n"
        "json.dump({'v': 6}, open(os.path.join(root, 'train.json'), 'w'))\n"
        "cfg = json.load(open('configs/train_e2fgvi_hq.json'))\n"
        "cfg['save_dir'] = TMP\n"
        "cfg['train_data_loader'].update(name='vos', data_root=TMP, w=216, "
        "h=120, num_local_frames=3, num_ref_frames=1)\n"
        "cfg['trainer'].update(batch_size=1, num_workers=1)\n"
        "json.dump(cfg, open(os.path.join(TMP, 'cfg.json'), 'w'))\n"
        "tr = trainer.main(['-c', os.path.join(TMP, 'cfg.json'), "
        "'--max_steps', '1', '--device', 'cpu'])\n"
        "print(tr.iteration)\n"),
}


def _port_sources():
    pkg = os.path.join(ROOT, "e2fgvi_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


def _blocked_imports(path):
    """(line, module) of every import of jax or the JAX package in the file,
    at any depth (inside functions too), including importlib.import_module
    and __import__ calls on a constant name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ast.unparse(node.func) in ("importlib.import_module",
                                             "import_module", "__import__")):
            names = [node.args[0].value]
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in _BLOCKED]
    return found


@pytest.mark.parametrize("case", ["ast", *_NO_JAX_CASES])
def test_port_imports_without_jax(case, tmp_path):
    """The port stands without jax and the JAX package: no module of it and
    no line of chip_smoke.py imports either (by its syntax tree, imports
    inside functions included); every module imports, and the inpaint and
    evaluate entry points run on the CPU, with both unimportable."""
    if case == "ast":
        files = _port_sources()
        assert len(files) >= 30
        # the training slice's modules are among them
        rel = {os.path.relpath(p, ROOT) for p in files}
        assert {f"e2fgvi_tpu_torch/{m}.py" for m in (
            "models/discriminator", "train/losses", "train/schedules",
            "train/step", "train/trainer", "parallel/dist",
            "utils/checkpoints", "utils/tb")} <= rel
        bad = {os.path.relpath(p, ROOT): hits for p in files
               if (hits := _blocked_imports(p))}
        assert not bad, bad
        # the walk sees imports nested in functions
        probe = tmp_path / "probe.py"
        probe.write_text("def f():\n    from e2fgvi_tpu.data import video\n"
                         "    import importlib\n"
                         "    importlib.import_module('jax.numpy')\n")
        assert [n for _, n in _blocked_imports(str(probe))] == [
            "e2fgvi_tpu.data", "jax.numpy"]
        return
    code = ("import sys, torch\ntorch.set_num_threads(2)\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in _BLOCKED)
            + f"TMP = {str(tmp_path)!r}\n" + _NO_JAX_CASES[case]
            + "bad = [m for m, v in sys.modules.items() if v is not None "
            f"and m.split('.')[0] in {_BLOCKED!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.strip().splitlines()[-1])
    assert n >= (15 if case == "modules" else 1)


def test_cuda_device_raises_without_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present on this machine")
    with pytest.raises(RuntimeError, match="CUDA"):
        env.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        env.device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.SlidingWindowInpainter(model, device="cuda")
    assert env.device("cpu").type == "cpu"


STAGES = ("encode", "flows", "feat_prop", "transformer", "decode", "blend")


@pytest.fixture(scope="module")
def served():
    """The HQ model (seeded) behind the pipeline at 108x60, 12 frames in
    window batches of 2 (3 windows: 2 batches), and an untimed call's
    output."""
    torch.manual_seed(0)
    runner = pipeline.SlidingWindowInpainter(
        tgen.Generator("hq").eval(), max_batch=2, out_dtype=np.uint8,
        device="cpu")
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (12, 60, 108, 3), dtype=np.uint8)
    masks = np.zeros((12, 60, 108, 1), np.uint8)
    masks[:, 20:44, 30:70] = 1
    video = (frames, masks.astype(np.float32), frames, masks)
    return runner, video, runner(*video)


def _ranges(fn):
    """inpaint.* ranges opened while fn() runs under the CPU profiler:
    [(name, start, end)] in start order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(timing.RANGE_PREFIX)),
                  key=lambda r: r[1])


def test_recorded_call_reports_its_spans(served):
    """The six stages plus prep and fetch; prep inside encode; the frames
    bit-identical to the untimed call's; no counter on this build."""
    runner, video, want = served
    timer = timing.StageTimer()
    got = runner(*video, timer=timer)
    stages = timer.totals()
    assert set(stages) == set(STAGES) | {"prep", "fetch"}
    assert 0 < stages["prep"] <= stages["encode"]
    assert all(v > 0 for v in stages.values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_recorded_call_ranges_nest(served):
    """Under the profiler: one inpaint.video around every span; prep
    within encode; the top-level spans in order, one after another, with
    feat_prop, transformer and decode once a window batch."""
    runner, video, _ = served
    timer = timing.StageTimer()
    ranges = _ranges(lambda: runner(*video, timer=timer))
    root = [r for r in ranges if r[0] == "inpaint.video"]
    assert len(root) == 1
    spans = [r for r in ranges if r[0] != "inpaint.video"]
    assert all(root[0][1] <= s <= e <= root[0][2] for _, s, e in spans)
    (prep,) = [r for r in spans if r[0] == "inpaint.prep"]
    top = [r for r in spans if r[0] != "inpaint.prep"]
    assert [n[len(timing.RANGE_PREFIX):] for n, _, _ in top] == [
        "encode", "flows"] + ["feat_prop", "transformer", "decode"] * 2 + [
        "blend", "fetch"]
    assert top[0][1] <= prep[1] <= prep[2] <= top[0][2]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    assert set(timer.totals()) == set(STAGES) | {"prep", "fetch"}


def test_unrecorded_call_records_nothing(served, monkeypatch):
    """timer=None opens no range and touches neither the sync debug mode
    nor the allocator's statistics (`memory_stats_as_nested_dict`)."""
    runner, video, want = served
    cuda = FakeCuda(monkeypatch)
    got = []
    assert _ranges(lambda: got.extend(runner(*video))) == []
    assert cuda.set_calls == [] and cuda.stats_calls == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_recorded_call_restores_the_sync_mode_on_error(served,
                                                       monkeypatch):
    """With CUDA's sync debug mode and allocator statistics stood in, a
    recorded call counts both, and one that raises mid-way (after its
    first window batch) still restores the mode and the warning filters
    it found."""
    runner, video, _ = served
    cuda = FakeCuda(monkeypatch, mode=2)
    timer = timing.StageTimer()
    runner(*video, timer=timer)
    stages = timer.totals()
    assert cuda.set_calls == ["warn", 2]
    assert stages["host_syncs"] == 0 and stages["device_alloc_calls"] == 0
    assert stages["host_syncs.prep"] == 0

    def fail(done, total):
        raise RuntimeError("stopped mid-way")

    filters, shown = list(warnings.filters), warnings.showwarning
    with pytest.raises(RuntimeError, match="mid-way"):
        runner(*video, timer=timer, progress=fail)
    assert cuda.set_calls == ["warn", 2, "warn", 2] and cuda.mode == 2
    assert warnings.filters == filters and warnings.showwarning is shown
    assert {"encode", "flows", "feat_prop", "transformer",
            "decode"} <= set(timer.totals())
