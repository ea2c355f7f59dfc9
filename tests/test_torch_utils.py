"""The port's utils/visualize against the JAX package's, exactly;
utils/profiling.trace on the CPU: its table, and that it raises where it
cannot trace; and utils/timing.StageTimer on the host clock: nested spans,
marks, totals, and its counters with CUDA's stood in."""

import types
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e2fgvi_tpu.utils import visualize as jvisualize
from e2fgvi_tpu_torch.kernels import conv
from e2fgvi_tpu_torch.utils import profiling, timing, visualize


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


class FakeCuda:
    """torch.cuda's sync debug mode and allocator statistics stood in on a
    build without CUDA: `sync()` warns as a synchronizing operation does
    in "warn" mode, `allocs` is the allocator's running count of driver
    calls."""

    def __init__(self, monkeypatch, mode=0):
        self.mode, self.set_calls, self.stats_calls, self.allocs = \
            mode, [], 0, 0
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                            lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self._set)
        monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                            self._stats)

    def _set(self, mode):
        self.set_calls.append(mode)
        self.mode = mode

    def _stats(self, device=None):
        self.stats_calls += 1
        return {"num_device_alloc": self.allocs, "num_device_free": 0}

    def sync(self):
        warnings.warn(timing.SYNC_WARNING + " (Triggered internally)")


@pytest.fixture
def host_clock(monkeypatch):
    """The timer's host clock reads 0, 1, 2, ... seconds."""
    ticks = iter(range(1000))
    monkeypatch.setattr(timing, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))


def test_stage_timer_nests_marks_and_resets(host_clock):
    t = timing.StageTimer()
    t.begin("encode")            # 0
    t.begin("prep")              # 1
    t.end("prep")                # 2
    t.mark("encode", "flows")    # 3: encode ends, flows begins
    t.mark("flows", "encode")    # 4
    t.mark("encode")             # 5
    assert t.totals() == {"prep": 1000.0, "encode": 4000.0, "flows": 1000.0}
    assert t.totals() == {}
    t.begin("a")
    t.begin("b")
    with pytest.raises(ValueError, match="innermost"):
        t.end("a")
    with pytest.raises(ValueError, match="innermost"):
        t.mark("a", "c")


def test_stage_timer_without_cuda_counts_nothing(host_clock, monkeypatch):
    """This build has no sync debug mode: a recorded call reads no counter
    and never sets the mode; spans left open are closed on the way out."""
    def refuse(*args):
        raise AssertionError("set_sync_debug_mode called")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    t = timing.StageTimer()
    with t.video(torch.device("cpu")):
        t.begin("encode")
        t.begin("prep")
    assert t.totals() == {"prep": 1000.0, "encode": 3000.0}


def test_stage_timer_charges_counts_to_the_innermost_span(monkeypatch):
    cuda = FakeCuda(monkeypatch, mode=1)
    monkeypatch.setitem(conv.LAUNCHES, "conv3x3", 0)
    monkeypatch.setitem(conv.LAUNCHES, "raft_conv", 0)
    monkeypatch.setitem(conv.LAUNCHES, "encoder", 0)
    t = timing.StageTimer()
    with t.video(torch.device("cpu")):
        assert cuda.set_calls == ["warn"]
        t.begin("encode")
        cuda.sync()
        conv.LAUNCHES["encoder"] += 18
        t.begin("prep")
        cuda.sync()
        cuda.sync()
        cuda.allocs += 3
        conv.LAUNCHES["conv3x3"] += 2
        with pytest.warns(DeprecationWarning, match="passed on"):
            warnings.warn("passed on", DeprecationWarning)
        t.end("prep")
        cuda.sync()
        t.mark("encode", "flows")
        cuda.allocs += 1
        conv.LAUNCHES["raft_conv"] += 5
        t.end("flows")
        cuda.sync()              # outside every span: in the sum only
    assert cuda.set_calls == ["warn", 1]
    got = t.totals()
    assert all(got.pop(span) >= 0 for span in ("encode", "prep", "flows"))
    assert got == {
        "host_syncs": 5, "host_syncs.encode": 2, "host_syncs.prep": 2,
        "host_syncs.flows": 0, "device_alloc_calls": 4,
        "device_alloc_calls.encode": 0, "device_alloc_calls.prep": 3,
        "device_alloc_calls.flows": 1, "conv_launches": 2,
        "conv_launches.encode": 0, "conv_launches.prep": 2,
        "conv_launches.flows": 0, "raft_conv_launches": 5,
        "raft_conv_launches.encode": 0, "raft_conv_launches.prep": 0,
        "raft_conv_launches.flows": 5, "encoder_conv_launches": 18,
        "encoder_conv_launches.encode": 18,
        "encoder_conv_launches.prep": 0, "encoder_conv_launches.flows": 0}
