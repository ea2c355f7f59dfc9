"""Seeded generator weights in the released checkpoints' layout, made on
the device in one draw.

Every weight matrix and conv kernel is N(0, gain^2 / fan_in), so that
activations keep their scale: He gains (sqrt 2) in the encoder, decoder
and SPyNet, whose layers are chains of (leaky) ReLU convs; unit gain in the
propagation, whose recurrence adds a residual at each of up to 10 steps,
and in the transformer, whose layer norms hold the scale. Three layers are
scaled down to what a trained model gives: each SPyNet level's last conv
(residual flows of about a pixel, not tens of pixels of random field), the
last offset-head conv of each deformable alignment (offsets within about a
pixel of the flows), and the decoder's last conv (outputs inside tanh's
range). A random network without those cuts is chaotic: a rounding of its
flows moves every warp by a fraction of a pixel, and its output at any
precision differs from float32 as much as at any other, so no comparison
could tell bfloat16 from fp8. Biases are zero, layer norms the identity,
and the window pooling a mean.
"""

import math

import torch

from reference.model import param_shapes

RELU_GAIN = math.sqrt(2.0)
# (name prefix, name suffix, gain): the first match sets the gain
GAINS = (
    ("update_spynet", "basic_module.4.conv.weight", 0.1),  # flow residual
    ("update_spynet", "", RELU_GAIN),
    ("feat_prop_module", "conv_offset.6.weight", 0.1),  # DCN offsets, masks
    ("feat_prop_module", "", 1.0),
    ("decoder.6", "", 0.5),                       # the last conv, to tanh
    ("encoder", "", RELU_GAIN),
    ("decoder", "", RELU_GAIN),
    ("", "", 1.0),
)


def leaf_rule(name, shape):
    """('normal', std) | ('const', value) for one state-dict entry."""
    if name.endswith("norm1.weight") or name.endswith("norm2.weight"):
        return "const", 1.0
    if "pool_layers" in name and name.endswith("weight"):
        return "const", 1.0 / shape[-1]
    if len(shape) < 2 or name == "sc.bias":       # biases, base bias map
        return "const", 0.0
    gain = next(g for pre, suf, g in GAINS
                if name.startswith(pre) and name.endswith(suf))
    return "normal", gain / math.sqrt(math.prod(shape[1:]))


def make_state_dict(variant, seed, device):
    """{name: float32 tensor} for the variant, from one torch.Generator
    draw on `device` seeded with `seed` (any integer up to 2**64 - 1)."""
    shapes = param_shapes(variant)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 64))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        kind, v = leaf_rule(name, shape)
        t = flat[at: at + n].view(shape)
        at += n
        # a tensor of its own: a view into the draw would be misaligned
        out[name] = (t.mul_(v) if kind == "normal" else t.fill_(v)).clone()
    return out
