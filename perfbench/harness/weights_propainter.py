"""Seeded weights of ProPainter's generator and its RAFT, in the released
checkpoints' layout, made on the device in one draw each.

As for E2FGVI (harness/weights.py): every weight matrix and conv kernel
is N(0, gain^2 / fan_in), He gains (sqrt 2) in the ReLU-chained encoders
and decoders, unit gain in the propagation and the transformer; biases
zero, layer norms the identity, the window pooling a mean (ProPainter's
own initialization of pool_layer), batch norms the identity. Three layers
are scaled down to what a trained model gives, so that a rounding moves
the output by a rounding and not by a random field: the last conv of each
offset head (offsets within a pixel of the flows), the decoder's last conv
(outputs inside tanh's range), and RAFT's flow head (updates of a tenth of
a 1/8-grid pixel, flows of a few pixels).
"""

import math

import torch

from reference.propainter import param_shapes

RELU_GAIN = math.sqrt(2.0)
# (model, name prefix, name suffix, gain): the first match sets the gain
GAINS = (
    ("generator", "feat_prop_module.deform_align", "conv_offset.6.weight",
     0.1),
    ("generator", "feat_prop_module", "", 1.0),
    ("generator", "decoder.6", "", 0.5),
    ("generator", "encoder", "", RELU_GAIN),
    ("generator", "decoder", "", RELU_GAIN),
    ("generator", "", "", 1.0),
    ("raft", "update_block.flow_head.conv2", "", 0.1),
    ("raft", "update_block.gru", "", 1.0),
    ("raft", "", "", RELU_GAIN),
)
# one draw per model: the seed's stream for RAFT is offset from the
# generator's
STREAMS = {"generator": 0, "raft": 0x5EED}


def leaf_rule(model, name, shape):
    """('normal', std) | ('const', value) | ('long', value)."""
    if name.endswith("num_batches_tracked"):
        return "long", 0
    if name.endswith("running_var") or (
            model == "raft" and len(shape) == 1 and name.endswith("weight")):
        return "const", 1.0            # batch norms (norm3 is downsample.1)
    if name.endswith("running_mean"):
        return "const", 0.0
    if name.endswith(("norm1.weight", "norm2.weight")):
        return "const", 1.0
    if name.endswith("pool_layer.weight"):
        return "const", 1.0 / math.prod(shape[-2:])
    if len(shape) < 2:
        return "const", 0.0
    gain = next(g for m, pre, suf, g in GAINS
                if m == model and name.startswith(pre)
                and name.endswith(suf))
    return "normal", gain / math.sqrt(math.prod(shape[1:]))


def make_state_dicts(seed, device):
    """{'generator': {name: tensor}, 'raft': {...}}, float32 (and int64
    batch counts), from the seed (any integer up to 2**64 - 1)."""
    out = {}
    for model, shapes in param_shapes().items():
        sizes = [math.prod(s) for _, s in shapes]
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) + STREAMS[model]) % (2 ** 64))
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=torch.float32)
        sd, at = {}, 0
        for (name, shape), n in zip(shapes, sizes):
            kind, v = leaf_rule(model, name, shape)
            t = flat[at: at + n].view(shape)
            at += n
            if kind == "long":
                sd[name] = torch.zeros(shape, dtype=torch.long, device=device)
            else:
                sd[name] = (t.mul_(v) if kind == "normal"
                            else t.fill_(v)).clone()
        out[model] = sd
    return out
