"""The port's utils/visualize against the JAX package's, exactly, and
utils/profiling.trace on the CPU: its table, and that it raises where it
cannot trace."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e2fgvi_tpu.utils import visualize as jvisualize
from e2fgvi_tpu_torch.utils import profiling, visualize


@pytest.mark.parametrize("clip_flow", [None, 2.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_flow_to_image_matches_jax(seed, clip_flow):
    rng = np.random.default_rng(seed)
    flow = (rng.standard_normal((23, 31, 2)) * 4).astype(np.float32)
    flow[0, 0] = 0.0                     # the wheel's centre
    got = visualize.flow_to_image(flow, clip_flow)
    want = jvisualize.flow_to_image(flow, clip_flow)
    assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, want)


def test_flow_to_image_refuses_other_shapes():
    with pytest.raises(ValueError):
        visualize.flow_to_image(np.zeros((4, 5, 3), np.float32))


def test_trace_returns_the_top_operations(tmp_path):
    x = torch.randn(2, 8, 32, 32)
    w = torch.randn(16, 8, 3, 3)
    with profiling.trace(str(tmp_path), device="cpu") as table:
        for _ in range(3):
            F.conv2d(x, w, padding=1)
    assert table["device"] == "cpu"
    assert 0 < len(table["top"]) <= profiling.TOP
    ms = [r["ms"] for r in table["top"]]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0
    assert sum(ms) <= table["busy_ms"] + 1e-9
    assert any("conv" in r["name"] and r["calls"] >= 3
               for r in table["top"]), table["top"]
    assert table["wall_ms"] > 0
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_trace_raises_when_the_profiler_fails(monkeypatch):
    class Broken:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            raise RuntimeError("profiler unavailable")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    ran = []
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.trace(device="cpu"):
            ran.append(True)
    assert not ran


def test_trace_raises_when_nothing_ran_on_the_device():
    with pytest.raises(RuntimeError, match="recorded no time"):
        with profiling.trace(device="cpu"):
            pass


def test_trace_without_cuda_refuses_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace():
            pass
