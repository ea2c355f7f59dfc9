"""The port's native host ops (e2fgvi_tpu_torch/data/native.py, built by
g++ from e2fgvi_tpu_torch/csrc/host_ops.cpp at first use) against their
numpy versions and the JAX package's, bit for bit: the cross dilation on
seeded masks of odd shapes (sparse, dense, empty, full, values other than
1), iterations 0-4, against the port's numpy dilate_cross and the JAX
package's masks.dilate_cross; the composite + blend against the formula of
e2fgvi_tpu/data/native.py:78-80, with and without a previous frame.
"""

import ast
import os

import numpy as np
import pytest

from e2fgvi_tpu.data import masks as jmasks
from e2fgvi_tpu_torch.data import masks, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 1), (1, 9), (7, 13), (31, 5), (64, 97), (120, 216)]


def _masks(rng, shape):
    yield (rng.uniform(size=shape) > 0.97).astype(np.uint8)
    yield (rng.uniform(size=shape) > 0.5).astype(np.uint8) * 255
    yield np.zeros(shape, np.uint8)
    yield np.ones(shape, np.uint8)


@pytest.mark.parametrize("iters", [0, 1, 2, 3, 4])
def test_dilate_cross_bit_equal_to_numpy_and_jax(iters):
    rng = np.random.default_rng(iters)
    n = 0
    for shape in SHAPES:
        for m in _masks(rng, shape):
            got = native.dilate_cross(m, iters)
            assert got.dtype == np.uint8 and got.shape == shape
            np.testing.assert_array_equal(got, masks.dilate_cross(m, iters))
            np.testing.assert_array_equal(got, jmasks.dilate_cross(m, iters))
            n += 1
    assert n == 4 * len(SHAPES)


@pytest.mark.parametrize("blend", [False, True])
def test_composite_blend_bit_equal_to_the_formula(blend):
    rng = np.random.default_rng(7 + blend)
    for h, w in SHAPES:
        pred = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        pred.reshape(-1)[:4] = [0.0, 255.0, 254.99998, 17.0][:pred.size]
        orig = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = (rng.uniform(size=(h, w)) > 0.4).astype(np.uint8)
        prev = (rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
                if blend else None)
        got = native.composite_blend(pred, orig, mask, prev)
        want = native.composite_blend_plain(pred, orig, mask, prev)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="composite_blend"):
        native.composite_blend(pred[:, :-1], orig, mask, prev)


def test_masks_dilate_through_the_native_op(monkeypatch):
    from PIL import Image
    rng = np.random.default_rng(3)
    img = Image.fromarray((rng.uniform(size=(37, 53)) > 0.9).astype(
        np.uint8) * 200)
    calls = []
    real = native.dilate_cross
    monkeypatch.setattr(native, "dilate_cross",
                        lambda m, it: calls.append(it) or real(m, it))
    got = masks.binarize_and_dilate(img, (27, 19), 3)
    assert calls == [3]
    m = (np.array(img.resize((27, 19), Image.NEAREST)) > 0).astype(np.uint8)
    np.testing.assert_array_equal(got, masks.dilate_cross(m, 3))


def test_build_from_the_ports_source_and_raise_on_failure(monkeypatch,
                                                          tmp_path):
    assert native.SOURCE.parent == native.BUILD_DIR.parent / \
        "e2fgvi_tpu_torch" / "csrc"
    assert native.library_path().parent == native.BUILD_DIR
    assert os.path.isfile(native.build())
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_port_reads_nothing_under_native():
    """No module of the port names the JAX package's native/ directory:
    its source and library are the port's own."""
    hits = []
    for dirpath, _, names in os.walk(os.path.join(ROOT, "e2fgvi_tpu_torch")):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    tree = ast.parse(f.read())
                hits += [(path, n.value) for n in ast.walk(tree)
                         if isinstance(n, ast.Constant)
                         and isinstance(n.value, str)
                         and (n.value == "native"
                              or "native/" in n.value)]
    assert not hits, hits
