"""The frozen plain reference against the repository's goldens, made by
the original E2FGVI code, at the bars the port's own tests use; and the
reference's independence from the program and from JAX."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

from reference import model as ref_model  # noqa: E402
from reference import protocol  # noqa: E402


GOLDENS = os.path.join(ROOT, "tests", "goldens")
BANNED = {"jax", "jaxlib", "flax", "e2fgvi_tpu", "e2fgvi_tpu_torch"}


def golden_weights(data):
    """The goldens' weight rule (tests/test_generator_golden.py)."""
    rng = np.random.default_rng(7)
    out = {}
    for key, s in zip(data["keys"], data["shapes"]):
        key, shape = str(key), ast.literal_eval(str(s))
        if key.endswith(("norm1.weight", "norm2.weight")):
            v = 1.0 + 0.05 * rng.standard_normal(shape)
        elif key.endswith(".bias"):
            v = 0.02 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            v = 0.5 / np.sqrt(fan_in) * rng.standard_normal(shape)
        out[key] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def load(variant, data):
    g = ref_model.Generator(variant)
    g.load_state_dict(golden_weights(data), strict=True)
    return g.eval()


def bar(want):
    return 2e-3 * np.abs(want).max() + 2e-5


@pytest.mark.parametrize("variant", ["base", "hq"])
def test_generator_matches_golden(variant):
    data = np.load(os.path.join(GOLDENS, f"generator_{variant}.npz"))
    g = load(variant, data)
    ops = ref_model.Ops()
    t, lt = int(data["t"]), int(data["lt"])
    h, w = int(data["h"]), int(data["w"])
    frames = np.random.default_rng(11).uniform(
        -1, 1, (t, 3, h, w)).astype(np.float32)
    x = torch.from_numpy(frames.transpose(0, 2, 3, 1).copy())
    with torch.no_grad():
        small = ref_model.resize_quarter((x[:lt] + 1.0) / 2.0)
        ff = ref_model.spynet(g, ops, small[:-1], small[1:])
        fb = ref_model.spynet(g, ops, small[1:], small[:-1])
        feat = ref_model.encode(g, ops, x)
        out = ref_model.window_forward(g, ops, feat[None], ff[None],
                                       fb[None], lt, n_out=t)
    got = out.numpy().transpose(0, 3, 1, 2)[:, :, ::5, ::7]
    assert np.abs(got - data["out_slice"]).max() < bar(data["out_slice"])
    for flow, key in ((ff, "flow_f_slice"), (fb, "flow_b_slice")):
        gf = flow.numpy()[None].transpose(0, 1, 4, 2, 3)[:, :, :, ::3, ::3]
        assert np.abs(gf - data[key]).max() < bar(data["flow_f_slice"]), key


def test_protocol_matches_golden():
    """The reference's test loop (windows alone, uint8 truncation,
    composite, sequential blend) against tests/goldens/protocol_base.npz,
    made by the original evaluate loop, at the port's protocol bars."""
    import cv2
    data = np.load(os.path.join(GOLDENS, "protocol_base.npz"))
    g = load("base", data)
    t, h, w = int(data["t"]), int(data["h"]), int(data["w"])
    rng = np.random.default_rng(13)
    low = rng.integers(0, 256, (t, h // 8, w // 8, 3)).astype(np.uint8)
    frames = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_CUBIC)
                       for f in low])
    masks = np.zeros((t, h, w), np.uint8)
    for i in range(t):
        masks[i, 60 + 4 * i: 130 + 4 * i, 40 + 9 * i: 130 + 9 * i] = 1
    for _ in range(4):                     # 3x3 cross dilation, 4 times
        m = masks.astype(bool)
        d = m.copy()
        d[:, :-1] |= m[:, 1:]
        d[:, 1:] |= m[:, :-1]
        d[:, :, :-1] |= m[:, :, 1:]
        d[:, :, 1:] |= m[:, :, :-1]
        masks = d.astype(np.uint8)
    masks = masks[..., None]
    comp = protocol.inpaint(g, ref_model.Ops(), frames, masks, frames, masks,
                            np.float32, "cpu")
    diff = np.abs(comp[:, ::4, ::6, :] - data["comp_slice"])
    assert diff.max() <= 1.0 + 1e-5, diff.max()
    assert (diff > 0.5).mean() < 5e-3, (diff > 0.5).mean()


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_neither_jax_nor_the_program():
    """Top-level module names compared whole: e2fgvi_tpu_torch begins with
    e2fgvi_tpu, and both are banned here."""
    ref_dir = os.path.join(BENCH, "reference")
    files = [os.path.join(ref_dir, f) for f in sorted(os.listdir(ref_dir))
             if f.endswith(".py")]
    assert len(files) >= 2
    for f in files:
        found = set(_imported_tops(f)) & BANNED
        assert not found, (f, found)
