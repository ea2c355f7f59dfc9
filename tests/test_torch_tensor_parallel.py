"""The port's tensor parallelism (e2fgvi_tpu_torch/parallel/tensor.py) on
the CPU, against the JAX package's 'model' mesh axis
(e2fgvi_tpu/parallel/mesh.py) and against one process.

- The shard plan names the leaves generator_param_sharding shards, on the
  same dims, through convert/from_jax.py's names (each JAX leaf filled with
  its own index, so a converted tensor says which leaf it came from).
- One transformer block at model_parallel 2 in 2 gloo processes against
  the JAX transformer_block jitted on a data 1 x model 2 mesh of the
  conftest's virtual CPU devices, its parameters placed by
  generator_param_sharding, both F3N forms; seeded weights with nonzero
  biases (a bias added on every rank shows), f32, max |delta| within
  BLOCK_REL of the output's scale (measured: 2.5e-7 conv, 2.0e-7 literal).
- A GAN step (remat on) at data 1 x model 2 against the single-process
  step on the same batch of 2: losses within rtol 1e-5 (measured 1.0e-7)
  and every gradient the optimizer steps read within TP_REL relative norm
  plus TP_FLOOR per element (measured: 0.385 of that at worst). Only the
  split GEMMs' summation order differs, but the gradients that cancel
  amplify it: the same single-process step at 1 and 2 CPU threads differs
  by up to 1.4e-3 in relative norm (a pool layer's bias; median 9e-5), so
  a bar of 1e-5 cannot be held. A rank whose gradient was not all-reduced
  is off by about 1. At data 2 x
  model 2 in 4 processes, the batch split over the data ranks:
  test_torch_distributed.py's bounds, GRAD_REL 2e-3 relative norm +
  GRAD_FLOOR per element (measured 0.454 of the bound at worst). Both
  ranks of a model group ran the same all-reduces in the same order,
  remat's replays of the forward ones among them.
- A checkpoint written by the Trainer at model_parallel 2 holds full
  tensors: restored at model_parallel 1 and 2 (the restore gathered back
  bit-equal to the files), the next step's losses agree within rtol 1e-5
  (measured 8.9e-8); the first step's agree with one process's (3.1e-7).
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu.models import e2fgvi as jgen
from e2fgvi_tpu.models import tfocal as jtf
from e2fgvi_tpu.parallel import mesh as jmesh
from e2fgvi_tpu_torch.convert import from_jax
from e2fgvi_tpu_torch.models import e2fgvi as tgen
from e2fgvi_tpu_torch.parallel import tensor
from test_torch_trainer import _config, mini_train_root  # noqa: F401

WORKER = os.path.join(os.path.dirname(__file__), "torch_tp_worker.py")
BLOCK_REL = 2e-5
TP_REL, TP_FLOOR = 1e-3, 1e-8
GRAD_REL, GRAD_FLOOR = 2e-3, 1e-9


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(mode, world, model, outdir):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("E2FGVI_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "MASTER_"))}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), str(model),
         str(port), str(outdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


# ---------------------------------------------------------------------------
# The grid and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [0, 3, 5, 8])
def test_model_parallel_must_divide_heads_and_f3n(m):
    with pytest.raises(ValueError, match="4 heads.*40 hidden"):
        tensor.check_model_parallel(m)


def test_grid_layout_is_make_meshs():
    assert [tensor.check_model_parallel(m) for m in (1, 2, 4)] == [1, 2, 4]
    grid = tensor.Grid(data=3, model=2, rank=5)
    assert (grid.data_index, grid.model_index) == (2, 1)
    devices = np.arange(6).reshape(3, 2)    # make_mesh's reshape(data, m)
    assert devices[grid.data_index, grid.model_index] == 5
    assert tensor.make_grid(1, 0, 1) == tensor.Grid(1, 1, 0)
    with pytest.raises(ValueError, match="do not split"):
        tensor.make_grid(3, 0, 2)


@pytest.mark.parametrize("variant", ["base", "hq"])
def test_shard_plan_matches_generator_param_sharding(variant):
    shapes = jax.eval_shape(lambda: jgen.init_params(jax.random.PRNGKey(0),
                                                     variant))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i + 1, np.float32)
                  for i, s in enumerate(leaves)])
    sd = from_jax.from_jax_params(tagged, variant)
    leaf_of = {}
    for k, v in sd.items():
        tag = v.reshape(-1)[0]
        assert torch.all(v == tag), k
        leaf_of[int(tag) - 1] = k
    assert len(leaf_of) == len(leaves) == len(sd)
    names = [n for n, _ in tgen.Generator(variant).named_parameters()]
    assert sorted(names) == sorted(sd)

    mesh = jmesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    specs = jax.tree_util.tree_leaves(
        jmesh.generator_param_sharding(mesh, shapes),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    plan = {n: tensor.shard_dim(n) for n in names}
    sharded = 0
    for i, (leaf, sharding) in enumerate(zip(leaves, specs)):
        spec = tuple(sharding.spec) + (None,) * (leaf.ndim
                                                 - len(sharding.spec))
        dims = [d for d, a in enumerate(spec) if a == "model"]
        # JAX linears are (in, out), the port's (out, in)
        want = None if not dims else (
            0 if leaf.ndim == 1 else leaf.ndim - 1 - dims[0])
        assert plan[leaf_of[i]] == want, (leaf_of[i], sharding.spec)
        sharded += want is not None
    assert sharded == 6 * 8       # qkv w/b, fc1 w/b, proj w, fc2 w x 8


def test_shards_round_trip_and_split_qkv_by_heads(rng):
    sd = {"transformer.0.attn.qkv.weight": rng.standard_normal((1536, 512)),
          "transformer.0.attn.qkv.bias": rng.standard_normal(1536),
          "transformer.0.attn.proj.weight": rng.standard_normal((512, 512)),
          "transformer.0.attn.proj.bias": rng.standard_normal(512),
          "transformer.0.mlp.conv1.0.weight": rng.standard_normal((1960,
                                                                   512)),
          "transformer.0.mlp.conv2.1.weight": rng.standard_normal((512,
                                                                   1960)),
          "encoder.layers.0.weight": rng.standard_normal((64, 3, 3, 3))}
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for m in (1, 2, 4):
        shards = [tensor.shard_state_dict(sd, m, r) for r in range(m)]
        back = tensor.gather_state_dict(shards)
        assert all(torch.equal(back[k], sd[k]) for k in sd)
        for r in range(m):
            q = shards[r]["transformer.0.attn.qkv.weight"].reshape(
                3, 4 // m, 128, 512)
            full = sd["transformer.0.attn.qkv.weight"].reshape(3, 4, 128,
                                                               512)
            assert torch.equal(q, full[:, r * 4 // m:(r + 1) * 4 // m])
            fc1 = shards[r]["transformer.0.mlp.conv1.0.weight"]
            assert torch.equal(fc1.reshape(40 // m, 49, 512), sd[
                "transformer.0.mlp.conv1.0.weight"].reshape(40, 49, 512)[
                r * 40 // m:(r + 1) * 40 // m])
            assert shards[r]["transformer.0.attn.proj.bias"] is sd[
                "transformer.0.attn.proj.bias"]


# ---------------------------------------------------------------------------
# One block against the JAX block on a 'model' mesh
# ---------------------------------------------------------------------------

def _jax_block(rng):
    """A JAX block's parameters, seeded, every bias nonzero."""
    def lin(cin, cout):
        return {"w": (rng.standard_normal((cin, cout)) / np.sqrt(cin)
                      ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(cout)).astype(np.float32)}
    return {
        "norm1": {"g": (1 + 0.1 * rng.standard_normal(512)).astype(
            np.float32), "b": (0.1 * rng.standard_normal(512)).astype(
            np.float32)},
        "norm2": {"g": (1 + 0.1 * rng.standard_normal(512)).astype(
            np.float32), "b": (0.1 * rng.standard_normal(512)).astype(
            np.float32)},
        "attn": {"qkv": lin(512, 1536), "proj": lin(512, 512)},
        "mlp": {"fc1": lin(512, 1960), "fc2": lin(1960, 512)},
        "pool": {"w": (1 / 45 + 0.01 * rng.standard_normal((45, 1))).astype(
            np.float32), "b": (0.1 * rng.standard_normal(1)).astype(
            np.float32)},
    }


@pytest.mark.parametrize("form", ["conv", "literal"])
def test_block_at_model_2_matches_jax_sharded_block(form, monkeypatch,
                                                    tmp_path):
    rng = np.random.default_rng(11)
    blk = _jax_block(rng)
    output_size = (30, 54)                   # a 10 x 18 token grid
    x = rng.standard_normal((1, 2, 10, 18, 512)).astype(np.float32)

    mesh = jmesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    placed = jmesh.shard_params(mesh, {"transformer": [blk]})["transformer"][0]
    assert placed["attn"]["qkv"]["w"].sharding.spec == (None, "model")
    assert placed["mlp"]["fc2"]["w"].sharding.spec == ("model", None)
    monkeypatch.setenv("E2FGVI_F3N", "conv" if form == "conv" else "gemm")
    fn = jax.jit(lambda p, z: jtf.transformer_block(p, z, output_size))
    want = np.asarray(fn(placed, jax.device_put(
        jnp.asarray(x), jmesh.replicated(mesh))))

    sd = from_jax.block_state(blk)
    np.savez(tmp_path / "block.npz", x=x, output_size=np.array(output_size),
             **{f"sd.{k}": np.asarray(v, np.float32) for k, v in sd.items()})
    (tmp_path / "form").write_text(form)
    _run("block", 2, 2, tmp_path)
    got = [np.load(tmp_path / f"block_{form}_{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    err = float(np.abs(got[0] - want).max())
    scale = float(np.abs(want).max())
    print(f"{form}: max |delta| {err:.3g}, {err / scale:.3g} of the scale")
    assert err <= BLOCK_REL * scale


# ---------------------------------------------------------------------------
# A GAN step over the grid against one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_step(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_step_1")
    _run("step", 1, 1, out)
    return torch.load(out / "step_0.pt", weights_only=True)


def _grid_step(world, model, tmp_path):
    _run("step", world, model, tmp_path)
    ranks = [torch.load(tmp_path / f"step_{r}.pt", weights_only=True)
             for r in range(world)]
    # data index 0's model ranks hold the shards; DDP made the other data
    # ranks' gradients theirs
    gen = {k: tensor.unshard_tensor(k, [ranks[r]["gen"][k]
                                        for r in range(model)])
           for k in ranks[0]["gen"]}
    return ranks, {"losses": ranks[0]["losses"], "dis": ranks[0]["dis"],
                   "gen": gen}


def _max_rel(got, want):
    return max(abs(got[k] - v) / abs(v) for k, v in want.items())


def _grad_errors(got, want, rel, floor):
    over, worst = {}, 0.0
    for m in ("dis", "gen"):
        assert set(got[m]) == set(want[m]) and want[m], m
        for k, w in want[m].items():
            w = w.double()
            err = float((got[m][k].double() - w).norm())
            bound = rel * float(w.norm()) + floor * w.numel() ** 0.5
            ratio = err / bound if bound else float(err > 0) * np.inf
            worst = max(worst, ratio)
            if not err <= bound:
                over[f"{m}.{k}"] = (err, bound)
    return over, worst


def test_model_parallel_step_matches_single_process(one_process_step,
                                                    tmp_path):
    ranks, got = _grid_step(2, 2, tmp_path)
    want = one_process_step
    assert set(got["losses"]) == set(want["losses"])
    assert "dis_loss" in want["losses"]
    print(f"losses max rel {_max_rel(got['losses'], want['losses']):.3g}")
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5,
                                   err_msg=k)
    # the split parameters' gradients are shards on each rank
    shapes = {k: tuple(v.shape) for k, v in ranks[0]["gen"].items()}
    assert shapes["transformer.0.attn.qkv.weight"] == (768, 512)
    assert shapes["transformer.0.mlp.conv2.1.weight"] == (512, 980)
    over, worst = _grad_errors(got, want, TP_REL, TP_FLOOR)
    print(f"worst gradient error over its bound: {worst:.3g}")
    assert not over, over
    # remat: both model ranks ran the same all-reduces in the same order:
    # the forward's two a block (attention, F3N); the discriminator's
    # gradients before its step; then per block in the backward the
    # replay of the attention's (the replay stops at the block's last saved
    # tensor, inside F3N before its all-reduce) and the gradients of F3N's
    # input and of attention's x and pooled; the generator's replicated
    # gradients before its step
    assert ranks[0]["trace"] == ranks[1]["trace"]
    kinds = [k for k, _ in ranks[0]["trace"]]
    assert kinds == (["forward"] * 16 + ["grads"]
                     + (["forward"] + 3 * ["backward"]) * 8 + ["grads"])


def test_data_and_model_parallel_step_matches_single_process(
        one_process_step, tmp_path):
    ranks, got = _grid_step(4, 2, tmp_path)
    want = one_process_step
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4,
                                   err_msg=k)
    # each model index's data ranks hold the same averaged shard
    for r in (0, 1):
        for k, g in ranks[r]["gen"].items():
            assert torch.equal(g, ranks[r + 2]["gen"][k]), (r, k)
    over, worst = _grad_errors(got, want, GRAD_REL, GRAD_FLOOR)
    print(f"worst gradient error over its bound: {worst:.3g}")
    assert not over, over


# ---------------------------------------------------------------------------
# Checkpoints: written at model_parallel 2, restored at 1 and 2
# ---------------------------------------------------------------------------

def test_model_parallel_checkpoint_restores_at_any_model_parallel(
        mini_train_root, tmp_path):
    root, name = mini_train_root
    cfg = _config(root, name, tmp_path / "mp2")

    def run(world, model, save_dir):
        out = tmp_path / f"run_{world}_{model}_{os.path.basename(save_dir)}"
        out.mkdir()
        with open(out / "config.json", "w") as f:
            json.dump({**cfg, "save_dir": str(save_dir)}, f)
        _run("trainer", world, model, out)
        return [torch.load(out / f"trainer_{r}.pt", weights_only=True)
                for r in range(world)]

    first = run(2, 2, tmp_path / "mp2")
    assert [r["iteration"] for r in first] == [1, 1]
    assert first[0]["losses"] == first[1]["losses"]
    sd = torch.load(tmp_path / "mp2" / "1" / "gen.pth", weights_only=True)
    assert sd["transformer.0.attn.qkv.weight"].shape == (1536, 512)
    opt = torch.load(tmp_path / "mp2" / "1" / "opt.pth", weights_only=True)
    assert any(v["exp_avg"].shape == (1536, 512)
               for v in opt["opt_g"]["state"].values())

    for d in ("at1", "at2"):
        shutil.copytree(tmp_path / "mp2", tmp_path / d)
    at1 = run(1, 1, tmp_path / "at1")
    at2 = run(2, 2, tmp_path / "at2")
    assert at1[0]["restored_equal"] and all(r["restored_equal"]
                                            for r in at2)
    assert at1[0]["iteration"] == at2[0]["iteration"] == 2
    want, got = at1[0]["losses"][2], at2[0]["losses"][2]
    assert set(got) == set(want)
    print(f"step 2 losses max rel {_max_rel(got, want):.3g}")
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    # and the first step itself agrees with one process's
    one = run(1, 1, tmp_path / "mp1")
    print(f"step 1 losses max rel "
          f"{_max_rel(first[0]['losses'][1], one[0]['losses'][1]):.3g}")
    for k, v in one[0]["losses"][1].items():
        np.testing.assert_allclose(first[0]["losses"][1][k], v, rtol=1e-5,
                                   err_msg=k)
