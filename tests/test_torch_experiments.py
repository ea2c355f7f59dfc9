"""The experiments package (e2fgvi_tpu_torch.experiments): importing a
module does no work, each main refuses to run without CUDA, and each
experiment's run() goes through its checks on the CPU at a small size
(the wrappers' plain versions, the CUDA-event timer replaced by one call).
"""

import importlib
import os
import sys

import pytest
import torch

from e2fgvi_tpu_torch.kernels import band_attention, band_sampler, gather

torch.set_num_threads(2)
MODULES = ("exp_dcn_inner_r04", "exp_dcn_pack", "exp_gather",
           "exp_attn_band_r04")


def _counts():
    return {**band_sampler.LAUNCHES, **gather.LAUNCHES,
            **band_attention.LAUNCHES}


@pytest.mark.parametrize("name", MODULES)
def test_import_sets_nothing_and_launches_nothing(name):
    env_before, argv_before = dict(os.environ), list(sys.argv)
    counts = _counts()
    sys.modules.pop(f"e2fgvi_tpu_torch.experiments.{name}", None)
    mod = importlib.import_module(f"e2fgvi_tpu_torch.experiments.{name}")
    assert callable(mod.main)
    assert dict(os.environ) == env_before
    assert sys.argv == argv_before
    assert _counts() == counts


@pytest.mark.parametrize("name", MODULES)
def test_main_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"e2fgvi_tpu_torch.experiments.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


@pytest.fixture
def one_call(monkeypatch):
    """cuda_ms -> one call and a time of 1 ms, for the CPU rehearsal."""
    def fake(fn, iters=10, warmup=2):
        fn()
        return 1.0
    for name in MODULES:
        mod = importlib.import_module(f"e2fgvi_tpu_torch.experiments.{name}")
        monkeypatch.setattr(mod, "cuda_ms", fake)


def test_dcn_inner_run_on_cpu(one_call):
    from e2fgvi_tpu_torch.experiments import exp_dcn_inner_r04 as m
    inputs = m.make_inputs("cpu", ng=2, k=2, cg=3, hp=8, wp=16, band=8,
                           width=12)
    res = m.run(*inputs)
    assert res["packed_exact"] is True
    assert set(res) >= set(m.VARIANTS)
    assert res["cbatch_vs_base_max_abs"] < 0.05


def test_dcn_pack_run_on_cpu(one_call):
    from e2fgvi_tpu_torch.experiments import exp_dcn_pack as m
    res = m.run(*m.make_inputs("cpu", band=16, b=1))
    assert res["max_abs_err"] == 0.0


def test_gather_run_on_cpu(one_call):
    from e2fgvi_tpu_torch.experiments import exp_gather as m
    res = m.run(*m.make_inputs("cpu", h=6, w=10), 6, 10)
    assert res["v2"]["max_err"] == 0.0 and res["v2b"]["max_err"] == 0.0
    assert res["v3"]["max_err"] == 0.0


def test_attn_band_run_on_cpu(one_call):
    """E2 (plain) and K3's layer (plain) agree on the CPU in float32."""
    from e2fgvi_tpu_torch.experiments import exp_attn_band_r04 as m
    block, x, pooled = m.make_block("cpu", b=2, t=4, c=64)
    block = block.float()
    res = m.run(block, x.float(), pooled.float())
    assert res["parity_rel"] < 1e-5 and res["parity_fv_rel"] < 1e-5
