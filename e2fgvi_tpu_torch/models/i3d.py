"""Inception-v1 I3D feature extractor for VFID, PyTorch.

Counterpart of e2fgvi_tpu/models/i3d.py (the reference's vendored
pytorch-i3d, core/metrics.py:196-570). Only the inference path VFID needs
is built: stem convs/pools -> Mixed_3b..Mixed_5c -> the mean of Mixed_5c
over (T', H', W') (the reference's extract_features never enters the
logits head, metrics.py:561-570).

TF-style 'same' padding is computed from each input's shape, as the
reference's compute_pad does (metrics.py:196-219, 259-280), so a video runs
at its exact length. BatchNorm is in eval form, folded on load into
(bn_mean, bn_scale, bn_bias) buffers with the JAX package's float32
arithmetic (e2fgvi_tpu/models/i3d.py:_convert_unit), so both packages see
identical numbers. Module names are the reference's, so a released
i3d_rgb_imagenet.pt loads through `load_reference_state_dict`.

Layout inside the model is NCDHW (cuDNN's 3-D convolutions); the public
function takes (B, T, H, W, 3) as the JAX package does.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (name, kind, spec); conv spec: (cin, cout, (kd,kh,kw), (sd,sh,sw));
# pool spec: ((kd,kh,kw), (sd,sh,sw))  (e2fgvi_tpu/models/i3d.py:24-45)
_STEM = [
    ("Conv3d_1a_7x7", "conv", (3, 64, (7, 7, 7), (2, 2, 2))),
    ("MaxPool3d_2a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", "conv", (64, 64, (1, 1, 1), (1, 1, 1))),
    ("Conv3d_2c_3x3", "conv", (64, 192, (3, 3, 3), (1, 1, 1))),
    ("MaxPool3d_3a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
]

# inception module (name, cin, output channel plan); a None cin is a pool
_MIXED = [
    ("Mixed_3b", 192, [64, 96, 128, 16, 32, 32]),
    ("Mixed_3c", 256, [128, 128, 192, 32, 96, 64]),
    ("MaxPool3d_4a_3x3", None, ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", 480, [192, 96, 208, 16, 48, 64]),
    ("Mixed_4c", 512, [160, 112, 224, 24, 64, 64]),
    ("Mixed_4d", 512, [128, 128, 256, 24, 64, 64]),
    ("Mixed_4e", 512, [112, 144, 288, 32, 64, 64]),
    ("Mixed_4f", 528, [256, 160, 320, 32, 128, 128]),
    ("MaxPool3d_5a_2x2", None, ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", 832, [256, 160, 320, 32, 128, 128]),
    ("Mixed_5c", 832, [384, 192, 384, 48, 128, 128]),
]

BN_EPS = 1e-3      # reference BatchNorm3d(eps=0.001), metrics.py:255-257
FEATURES = 1024


def _same_pad(size, kernel, stride):
    """TF-style same padding of one dim (reference compute_pad)."""
    if size % stride == 0:
        pad = max(kernel - stride, 0)
    else:
        pad = max(kernel - (size % stride), 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, kernel, stride, value=0.0):
    """Pad (B, C, T, H, W) for a 'same' window of kernel/stride."""
    pads = [_same_pad(x.shape[2 + i], kernel[i], stride[i])
            for i in range(3)]
    return F.pad(x, (*pads[2], *pads[1], *pads[0]), value=value)


def _maxpool_same(x, kernel, stride):
    # The reference pads with zeros, the JAX package with -inf. They agree
    # because every pooled input comes out of a ReLU (>= 0), so a zero pad
    # never wins where a real value is present; -inf is kept because it is
    # also right for inputs that could be negative.
    return F.max_pool3d(_pad_same(x, kernel, stride, float("-inf")),
                        kernel, stride)


class Unit3D(nn.Module):
    """conv3d (no bias) -> eval BatchNorm -> ReLU, TF-'same' padded."""

    def __init__(self, cin, cout, kernel=(1, 1, 1), stride=(1, 1, 1)):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=False)
        self.register_buffer("bn_mean", torch.zeros(cout))
        self.register_buffer("bn_scale", torch.ones(cout))
        self.register_buffer("bn_bias", torch.zeros(cout))

    def forward(self, x):
        x = F.conv3d(_pad_same(x, self.kernel, self.stride),
                     self.conv3d.weight, None, self.stride)
        shape = (1, -1, 1, 1, 1)
        x = ((x - self.bn_mean.view(shape)) * self.bn_scale.view(shape)
             + self.bn_bias.view(shape))
        return F.relu(x)


class InceptionModule(nn.Module):
    def __init__(self, cin, plan):
        super().__init__()
        o = plan
        self.b0 = Unit3D(cin, o[0])
        self.b1a = Unit3D(cin, o[1])
        self.b1b = Unit3D(o[1], o[2], (3, 3, 3))
        self.b2a = Unit3D(cin, o[3])
        self.b2b = Unit3D(o[3], o[4], (3, 3, 3))
        self.b3b = Unit3D(cin, o[5])

    def forward(self, x):
        b3 = _maxpool_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3b(b3)], 1)


class I3D(nn.Module):
    def __init__(self):
        super().__init__()
        for name, kind, spec in _STEM:
            if kind == "conv":
                cin, cout, k, s = spec
                self.add_module(name, Unit3D(cin, cout, k, s))
        for name, cin, plan in _MIXED:
            if cin is not None:
                self.add_module(name, InceptionModule(cin, plan))

    def forward(self, x):
        """x: (B, 3, T, H, W) in [0, 1] -> the pre-pool Mixed_5c map
        (B, 1024, T', H', W'), T' = ceil(T/8)."""
        for name, kind, spec in _STEM:
            x = (getattr(self, name)(x) if kind == "conv"
                 else _maxpool_same(x, *spec))
        for name, cin, spec in _MIXED:
            x = (_maxpool_same(x, *spec) if cin is None
                 else getattr(self, name)(x))
        return x

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """Random weights with the JAX init_params distributions:
        He-normal convs, identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, Unit3D):
                w = m.conv3d.weight
                std = float(np.sqrt(2.0 / (np.prod(w.shape[2:]) * w.shape[1])))
                w.copy_(torch.randn(w.shape, generator=gen) * std)
                m.bn_mean.zero_()
                m.bn_scale.fill_(1.0)
                m.bn_bias.zero_()
        return self


def i3d_features(model, video):
    """video: (B, T, H, W, 3) in [0, 1] (the reference feeds [0, 1],
    metrics.py:71-83). Returns (B, 1024), the mean of Mixed_5c."""
    return model(video.permute(0, 4, 1, 2, 3)).mean(dim=(2, 3, 4))


# ---------------------------------------------------------------------------
# Reference checkpoints (pytorch-i3d layout)
# ---------------------------------------------------------------------------

def _units(model):
    return [name for name, m in model.named_modules() if isinstance(m, Unit3D)]


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def load_reference_state_dict(model: I3D, sd: dict):
    """Load a pytorch-i3d state dict (i3d_rgb_imagenet.pt): drops the
    logits head and num_batches_tracked, folds each unit's BatchNorm into
    (bn_mean, bn_scale, bn_bias) as the JAX converter does, and loads with
    strict=True, so a missing or unexpected key raises."""
    keep = {k: v for k, v in sd.items() if not k.startswith("logits.")
            and not k.endswith(".num_batches_tracked")}
    out = {}
    for u in _units(model):
        out[f"{u}.conv3d.weight"] = torch.as_tensor(
            _np(keep.pop(f"{u}.conv3d.weight")), dtype=torch.float32)
        gamma, beta, mean, var = (
            _np(keep.pop(f"{u}.bn.{k}")).astype(np.float32)
            for k in ("weight", "bias", "running_mean", "running_var"))
        scale = gamma / np.sqrt(var + BN_EPS)     # float32, as _convert_unit
        out[f"{u}.bn_mean"] = torch.from_numpy(mean)
        out[f"{u}.bn_scale"] = torch.from_numpy(scale)
        out[f"{u}.bn_bias"] = torch.from_numpy(beta)
    if keep:
        raise RuntimeError(f"unexpected I3D keys: {sorted(keep)[:8]}")
    return model.load_state_dict(out, strict=True)


def load_i3d(path, device="cpu"):
    """An I3D from a reference .pt on `device`, in eval form."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = I3D()
    load_reference_state_dict(model, sd)
    return model.to(device).eval()


def random_reference_state_dict(gen: torch.Generator, num_classes=400):
    """A seeded state dict in the pytorch-i3d layout, logits head and
    num_batches_tracked included: He-normal convs and BatchNorm statistics
    away from identity, so the fold is exercised. For tests and smoke runs
    where the released weights are absent."""
    sd = {}
    model = I3D()
    for u in _units(model):
        w = model.get_submodule(u).conv3d.weight
        cout = w.shape[0]
        std = float(np.sqrt(2.0 / (np.prod(w.shape[2:]) * w.shape[1])))
        sd[f"{u}.conv3d.weight"] = torch.randn(w.shape, generator=gen) * std
        sd[f"{u}.bn.weight"] = 1.0 + 0.1 * torch.randn(cout, generator=gen)
        sd[f"{u}.bn.bias"] = 0.1 * torch.randn(cout, generator=gen)
        sd[f"{u}.bn.running_mean"] = 0.1 * torch.randn(cout, generator=gen)
        sd[f"{u}.bn.running_var"] = 0.5 + torch.rand(cout, generator=gen)
        sd[f"{u}.bn.num_batches_tracked"] = torch.tensor(0)
    sd["logits.conv3d.weight"] = 0.02 * torch.randn(
        (num_classes, FEATURES, 1, 1, 1), generator=gen)
    sd["logits.conv3d.bias"] = torch.zeros(num_classes)
    return sd
