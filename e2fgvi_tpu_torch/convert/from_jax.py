"""JAX-package parameters -> the port's (reference-layout) state dict.

The exact inverse of e2fgvi_tpu/convert/torch_loader.py:convert_generator
(both variants): HWIO -> OIHW convs, (in, out) -> (out, in) Linears, the
kernel-major -> channel-major patch permutations of ss/sc and the F3N
fc1/fc2 (torch_loader._patch_linear_in/_out), and the sc bias map HWC ->
CHW (base) or the sc bias conv HWIO -> OIHW (HQ). Every step is a
permutation, so a round trip is bit-exact.

Input: the JAX pytree with numpy leaves (np.asarray over the tree).
Output: {key: float32 torch.Tensor} in the released checkpoint's keys.

Training carries over too: the discriminator (discriminator_state: DHWIO
conv weights -> OIDHW, the last conv's bias, the spectral-norm vectors u)
and a JAX TrainState (e2fgvi_tpu/train/step.py:31) as a whole
(from_jax_train_state: generator, discriminator, the frozen SPyNet, the
step), so both packages can start training from one state.
"""

import numpy as np
import torch

_PATCH_K = 49


def _conv(p, prefix):
    return {f"{prefix}.weight": np.asarray(p["w"]).transpose(3, 2, 0, 1),
            f"{prefix}.bias": np.asarray(p["b"])}


def _linear(p, prefix):
    return {f"{prefix}.weight": np.asarray(p["w"]).T,
            f"{prefix}.bias": np.asarray(p["b"])}


def _patch_linear_in(p, prefix, c, k=_PATCH_K):
    """Inverse of torch_loader._patch_linear_in: (k*c, out) -> (out, c*k)."""
    w = np.asarray(p["w"])
    out = w.shape[1]
    w = w.reshape(k, c, out).transpose(2, 1, 0).reshape(out, c * k)
    return {f"{prefix}.weight": w, f"{prefix}.bias": np.asarray(p["b"])}


def _patch_linear_out(p, prefix, c, k=_PATCH_K):
    """Inverse of torch_loader._patch_linear_out: (in, k*c) -> (c*k, in)."""
    w = np.asarray(p["w"])
    cin = w.shape[0]
    w = w.T.reshape(k, c, cin).transpose(1, 0, 2).reshape(c * k, cin)
    b = np.asarray(p["b"]).reshape(k, c).T.reshape(-1)
    return {f"{prefix}.weight": w, f"{prefix}.bias": b}


def spynet_state(sp, prefix="update_spynet."):
    sd = {}
    for lvl, mod in enumerate(sp["modules"]):
        for m in range(5):
            sd.update(_conv(mod[f"conv{m}"],
                            f"{prefix}basic_module.{lvl}.basic_module.{m}.conv"))
    return sd


def feat_prop_state(fp, prefix="feat_prop_module."):
    sd = {}
    for direction in ("backward", "forward"):
        d = fp[direction]
        tk = f"{direction}_"
        sd.update(_conv(d["deform"], f"{prefix}deform_align.{tk}"))
        for j, cp in zip((0, 2, 4, 6), d["deform"]["conv_offset"]):
            sd.update(_conv(cp, f"{prefix}deform_align.{tk}.conv_offset.{j}"))
        for j, cp in zip((0, 2), d["backbone"]):
            sd.update(_conv(cp, f"{prefix}backbone.{tk}.{j}"))
    sd.update(_conv(fp["fusion"], f"{prefix}fusion"))
    return sd


def block_state(blk, prefix=""):
    """One transformer block; F3N hidden width d_ff = 49 * c."""
    c = np.asarray(blk["mlp"]["fc1"]["w"]).shape[1] // _PATCH_K
    sd = {}
    for norm in ("norm1", "norm2"):
        sd[f"{prefix}{norm}.weight"] = np.asarray(blk[norm]["g"])
        sd[f"{prefix}{norm}.bias"] = np.asarray(blk[norm]["b"])
    sd.update(_linear(blk["attn"]["qkv"], f"{prefix}attn.qkv"))
    sd.update(_linear(blk["attn"]["proj"], f"{prefix}attn.proj"))
    sd.update(_patch_linear_out(blk["mlp"]["fc1"], f"{prefix}mlp.conv1.0", c))
    sd.update(_patch_linear_in(blk["mlp"]["fc2"], f"{prefix}mlp.conv2.1", c))
    sd.update(_linear(blk["pool"], f"{prefix}pool_layers.0"))
    return sd


def to_torch(sd):
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def from_jax_params(params_np, variant="base") -> dict:
    """Generator pytree (numpy leaves) -> reference state dict; variant
    'base' or 'hq', as given to convert_generator."""
    p = params_np
    sd = {}
    for i, conv in enumerate(p["encoder"]):
        sd.update(_conv(conv, f"encoder.layers.{2 * i}"))
    for name, conv in zip(("decoder.0.conv", "decoder.2", "decoder.4.conv",
                           "decoder.6"), p["decoder"]):
        sd.update(_conv(conv, name))
    sd.update(feat_prop_state(p["feat_prop"]))
    c = 128
    sd.update(_patch_linear_in(p["ss"]["embedding"], "ss.embedding", c))
    sd.update(_patch_linear_out(p["sc"]["embedding"], "sc.embedding", c))
    if variant == "base":
        sd["sc.bias"] = np.asarray(p["sc"]["bias"]).transpose(2, 0, 1)
    elif variant == "hq":
        sd.update(_conv(p["sc"]["bias_conv"], "sc.bias_conv"))
    else:
        raise ValueError(f"variant {variant!r} is neither 'base' nor 'hq'")
    for i, blk in enumerate(p["transformer"]):
        sd.update(block_state(blk, f"transformer.{i}."))
    sd.update(spynet_state(p["spynet"]))
    return to_torch(sd)


def discriminator_state(params_d) -> dict:
    """JAX discriminator pytree (numpy leaves) -> the port's Discriminator
    state dict: convs.{i}.weight OIDHW, convs.5.bias, u{i} for the
    spectral-normalized convs (the last conv's u, unused, is dropped)."""
    sd = {}
    for i, conv in enumerate(params_d["convs"]):
        sd[f"convs.{i}.weight"] = np.asarray(conv["w"]).transpose(4, 3, 0, 1,
                                                                  2)
        if "b" in conv:
            sd[f"convs.{i}.bias"] = np.asarray(conv["b"])
        else:
            sd[f"u{i}"] = np.asarray(params_d["u"][i])
    return to_torch(sd)


def from_jax_train_state(state_np, variant="base") -> dict:
    """A JAX TrainState (numpy leaves) -> {"gen": the generator's state
    dict, "dis": the discriminator's, "fixed_spynet": the frozen SPyNet's
    (SPyNet keys), "step": int}. Optimizer moments are not carried."""
    return {"gen": from_jax_params(state_np.params_g, variant),
            "dis": discriminator_state(state_np.params_d),
            "fixed_spynet": to_torch(spynet_state(state_np.fixed_spynet,
                                                  prefix="")),
            "step": int(np.asarray(state_np.step))}
