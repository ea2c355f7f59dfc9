"""The port's I3D (VFID features) against the JAX package's on one
reference-layout state dict, and the reference-checkpoint loader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from e2fgvi_tpu.models import i3d as ji3d
from e2fgvi_tpu_torch.models import i3d

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference_sd():
    return i3d.random_reference_state_dict(torch.Generator().manual_seed(3))


def test_i3d_features_match_jax(reference_sd):
    """(1, 16, 36, 36, 3), the size tests/test_i3d.py runs at; BatchNorm
    statistics away from identity. Max |delta| against the JAX package is
    1.4e-5 on features of scale 23, well inside its own 2e-3 bar."""
    video = np.random.default_rng(0).uniform(
        0, 1, (1, 16, 36, 36, 3)).astype(np.float32)
    want = np.asarray(jax.jit(ji3d.i3d_features)(
        ji3d.convert_i3d(reference_sd), jnp.asarray(video)))
    model = i3d.I3D()
    i3d.load_reference_state_dict(model, reference_sd)
    with torch.no_grad():
        got = i3d.i3d_features(model.eval(), torch.from_numpy(video)).numpy()
    assert got.shape == (1, i3d.FEATURES)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_loader_folds_batchnorm_as_jax(reference_sd):
    """The folded BatchNorm buffers and the conv weights are bit-equal to
    the JAX converter's parameters."""
    params = ji3d.convert_i3d(reference_sd)
    model = i3d.I3D()
    i3d.load_reference_state_dict(model, reference_sd)
    for unit, jp in (("Conv3d_1a_7x7", params["Conv3d_1a_7x7"]),
                     ("Mixed_4e.b2b", params["Mixed_4e"]["b2b"])):
        m = model.get_submodule(unit)
        for buf in ("bn_mean", "bn_scale", "bn_bias"):
            assert np.array_equal(getattr(m, buf).numpy(),
                                  np.asarray(jp[buf])), (unit, buf)
        assert np.array_equal(m.conv3d.weight.detach().numpy(),
                              np.asarray(jp["w"]).transpose(4, 3, 0, 1, 2))


def test_loader_drops_logits_and_refuses_strays(reference_sd, tmp_path):
    """A pytorch-i3d checkpoint carries the logits head and
    num_batches_tracked: both are dropped; any other unknown or missing key
    raises."""
    assert any(k.startswith("logits.") for k in reference_sd)
    assert any(k.endswith("num_batches_tracked") for k in reference_sd)
    path = tmp_path / "i3d_rgb_imagenet.pt"
    torch.save(reference_sd, path)
    model = i3d.load_i3d(path)
    assert not model.training
    assert not any("logits" in k for k in model.state_dict())

    stray = dict(reference_sd, **{"Mixed_5c.extra.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="unexpected"):
        i3d.load_reference_state_dict(i3d.I3D(), stray)
    missing = {k: v for k, v in reference_sd.items()
               if not k.startswith("Mixed_3b.b0.")}
    with pytest.raises(KeyError, match="Mixed_3b.b0"):
        i3d.load_reference_state_dict(i3d.I3D(), missing)


def test_init_weights_match_jax_distributions():
    """He-normal convs (std sqrt(2 / fan_in)) and identity BatchNorm, as
    e2fgvi_tpu.models.i3d.init_params draws them."""
    model = i3d.I3D().init_weights(torch.Generator().manual_seed(0))
    m = model.Mixed_4f.b1b
    w = m.conv3d.weight.detach()
    assert abs(float(w.std()) / np.sqrt(2.0 / (27 * 160)) - 1.0) < 0.02
    assert (m.bn_mean == 0).all() and (m.bn_scale == 1).all()
    assert (m.bn_bias == 0).all()


@pytest.mark.parametrize("size, kernel, stride", [
    ((5, 9, 10), (3, 3, 3), (1, 1, 1)),
    ((8, 15, 27), (1, 3, 3), (1, 2, 2)),
    ((3, 4, 7), (2, 2, 2), (2, 2, 2))])
def test_maxpool_pad_value_is_moot_after_relu(size, kernel, stride):
    """The reference pads its max pools with zeros, the JAX package and the
    port with -inf: on ReLU outputs (>= 0) the two agree exactly."""
    x = F.relu(torch.randn((1, 4, *size),
                           generator=torch.Generator().manual_seed(1)))
    zero = F.max_pool3d(i3d._pad_same(x, kernel, stride, 0.0), kernel,
                        stride)
    assert torch.equal(i3d._maxpool_same(x, kernel, stride), zero)
