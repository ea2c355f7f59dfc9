"""The port's weight converter (e2fgvi_tpu_torch/convert/from_jax.py) is
the exact inverse of the JAX package's convert_generator, and the port's
Generator takes the reference state dict with strict=True."""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from e2fgvi_tpu.convert.torch_loader import convert_generator
from e2fgvi_tpu_torch.convert.from_jax import from_jax_params
from e2fgvi_tpu_torch.models import e2fgvi as tgen
from test_generator_golden import fill_weight

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "generator_base.npz")


@pytest.fixture(scope="module")
def reference_sd():
    data = np.load(GOLDEN)
    keys = [str(k) for k in data["keys"]]
    shapes = [ast.literal_eval(str(s)) for s in data["shapes"]]
    rng = np.random.default_rng(7)
    return {k: fill_weight(k, s, rng) for k, s in zip(keys, shapes)}


def test_round_trip_is_bit_exact(reference_sd):
    params = jax.tree.map(np.asarray, convert_generator(reference_sd, "base"))
    back = from_jax_params(params)
    assert sorted(back) == sorted(reference_sd)
    for k, v in reference_sd.items():
        assert back[k].shape == v.shape, k
        assert np.array_equal(back[k].numpy(), v), k


def test_generator_loads_reference_strict(reference_sd):
    model = tgen.Generator()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in reference_sd.items()}, strict=True)
    sd = model.state_dict()
    assert sorted(sd) == sorted(reference_sd)


def test_reference_buffers_are_dropped(reference_sd):
    """A released checkpoint also carries buffers the port recomputes."""
    sd = {k: torch.from_numpy(v) for k, v in reference_sd.items()}
    sd["update_spynet.mean"] = torch.zeros(1, 3, 1, 1)
    sd["update_spynet.std"] = torch.ones(1, 3, 1, 1)
    sd["transformer.0.attn.valid_ind_rolled"] = torch.zeros(4, dtype=torch.long)
    sd["transformer.3.attn.valid_ind_unfold_k"] = torch.zeros(2, dtype=torch.long)
    model = tgen.Generator()
    tgen.load_reference_state_dict(model, sd)
    with pytest.raises(RuntimeError):
        tgen.Generator().load_state_dict(sd, strict=True)


def test_init_mirrors_jax_distributions():
    """Seeded init: the zero offset-head last layer, mean pooling, unit
    norms, and N(0, 0.02) weights."""
    gen = torch.Generator().manual_seed(0)
    model = tgen.Generator().init_weights(gen)
    for d in model.feat_prop_module.deform_align.values():
        assert not d.conv_offset[-1].weight.any()
    blk = model.transformer[0]
    assert torch.allclose(blk.pool_layers[0].weight,
                          torch.full((1, 45), 1.0 / 45))
    assert torch.equal(blk.norm1.weight, torch.ones(512))
    std = float(blk.attn.qkv.weight.detach().std())
    assert abs(std - 0.02) < 1e-3, std
    again = tgen.Generator().init_weights(torch.Generator().manual_seed(0))
    assert torch.equal(again.ss.embedding.weight, model.ss.embedding.weight)


def test_train_state_carries_across():
    """A JAX TrainState (HQ generator, discriminator, frozen SPyNet, step)
    through from_jax_train_state into the port's modules, strict; the
    generator's weights are from_jax_params' (bit-exact, above); then one
    forward on the same input: the discriminator's logits, the frozen
    SPyNet's flows and the generator's trainable SPyNet's within 1e-4
    relative."""
    import jax.numpy as jnp
    from e2fgvi_tpu.models import discriminator as jdisc
    from e2fgvi_tpu.models import e2fgvi as jgen
    from e2fgvi_tpu.models import spynet as jspynet
    from e2fgvi_tpu.train import step as jstep
    from e2fgvi_tpu_torch.convert.from_jax import from_jax_train_state
    from e2fgvi_tpu_torch.models import discriminator, spynet

    params_g = jgen.init_params(jax.random.PRNGKey(0), variant="hq")
    params_d = jdisc.init_params(jax.random.PRNGKey(1))
    fixed = jspynet.init_params(jax.random.PRNGKey(2))
    tx_g, tx_d = jstep.make_optimizers(1e-4, lambda s: 1e-4)
    state = jstep.init_train_state(params_g, params_d, fixed, tx_g, tx_d)
    state = state._replace(step=jnp.asarray(7, jnp.int32))
    carried = from_jax_train_state(jax.tree.map(np.asarray, state), "hq")
    assert carried["step"] == 7
    gen = tgen.Generator("hq")
    gen.load_state_dict(carried["gen"], strict=True)
    dis = discriminator.Discriminator()
    dis.load_state_dict(carried["dis"], strict=True)
    net = spynet.SPyNet()
    net.load_state_dict(carried["fixed_spynet"], strict=True)

    for k, v in from_jax_params(jax.tree.map(np.asarray, params_g),
                                "hq").items():
        assert torch.equal(gen.state_dict()[k], v), k

    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (1, 4, 60, 108, 3)).astype(np.float32)
    wlog, _ = jdisc.apply(params_d, jnp.asarray(x), update_stats=True)
    with torch.no_grad():
        glog = dis(torch.from_numpy(x), update=True)
    np.testing.assert_allclose(glog.numpy(), np.asarray(wlog), rtol=1e-4,
                               atol=1e-6)
    a, b = x[0, :2] * 0.5 + 0.5, x[0, 2:] * 0.5 + 0.5
    for jp, tnet in ((fixed, net), (params_g["spynet"], gen.update_spynet)):
        wflow = jspynet.spynet_flow(jp, jnp.asarray(a), jnp.asarray(b))
        with torch.no_grad():
            gflow = tnet(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(gflow.numpy(), np.asarray(wflow),
                                   rtol=1e-4, atol=1e-4)
