"""Seeded weights of Wan2.1-VACE's DiT (with its context blocks) and its
VAE, in the released checkpoints' layout, and the seeded prompt
embeddings that stand in for umT5's outputs; made on the device, one
tensor after another from one generator per model.

Every weight matrix and conv kernel is N(0, gain^2 / fan_in), unit gain;
biases zero; layer norms and the VAE's RMS norms the identity; the
modulations N(0, 1 / dim), as Wan initialises them. VACE's zero-
initialised projections (before_proj, after_proj), the DiT's head and
the VAE attention's output projection get the same nonzero draw as the
rest, so the context branch and the head do work. Two settings stand in
for what a trained model has: the q and k RMS norms' gains make the
logits of every attention N(0, QK_GAIN^4)-spread over 128 dimensions, a
peaked attention whose rows depend on where the keys are (with unit gains
the 32,760 keys of a row weigh nearly alike, and the output is their
mean); the VAE decoder's last conv is scaled down so that its output lies
inside the clamp.
"""

import math

import torch

from reference.wan_vace import param_shapes

QK_GAIN = 3.0 ** 0.25
# (model, name suffix, gain): the first match sets the gain
GAINS = (("vae", "decoder.head.2.weight", 0.5),)
STREAMS = {"dit": 0, "vae": 0x5EED, "context": 0xC0DE}


def leaf_rule(model, name, shape):
    """('normal', std) | ('const', value)."""
    if name.endswith("bias"):
        return "const", 0.0
    if name.endswith("modulation"):
        return "normal", 1.0 / math.sqrt(shape[-1])
    if name.endswith(("norm_q.weight", "norm_k.weight")):
        return "const", QK_GAIN
    if name.endswith(("norm3.weight", "gamma")):
        return "const", 1.0
    gain = next((g for m, suf, g in GAINS
                 if m == model and name.endswith(suf)), 1.0)
    return "normal", gain / math.sqrt(math.prod(shape[1:]))


def make_state_dicts(seed, device, config):
    """{'dit': {name: tensor}, 'vae': {...}} float32 from the seed (any
    integer up to 2**64 - 1) for `config` ({'dit': kwargs, 'vae':
    kwargs})."""
    out = {}
    for model, shapes in param_shapes(config).items():
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) + STREAMS[model]) % (2 ** 64))
        sd = {}
        for name, shape in shapes:
            kind, v = leaf_rule(model, name, shape)
            if kind == "const":
                sd[name] = torch.full(shape, v, device=device)
            else:
                sd[name] = torch.randn(shape, generator=gen,
                                       device=device).mul_(v)
        out[model] = sd
    return out


def make_contexts(seed, device, text_len, text_dim, tokens):
    """(prompt, negative prompt): `tokens` (prompt, negative) rows of
    N(0, 1) each, rounded to bfloat16 (umT5's output dtype in Wan), zero-
    padded to text_len as Wan pads umT5's output; float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + STREAMS["context"]) % (2 ** 64))
    out = []
    for n in tokens:
        c = torch.zeros((text_len, text_dim), device=device)
        c[:n] = torch.randn((n, text_dim), generator=gen, device=device) \
            .to(torch.bfloat16).float()
        out.append(c)
    return tuple(out)
