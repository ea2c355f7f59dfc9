"""The work a video needs, counted from the model's math: the yardstick of
the roofline and MFU metrics.

Operations are multiply-adds times two, of every convolution, Linear and
attention product, as torch.utils.flop_counter counts them. Each window is
counted at its own length with its real frames only: the end padding that
batching adds, and the propagation steps on padding frames, are work these
inputs do not need, so a program that skips them reads higher and never
above the peak.

Attention keys: "dedup" counts each window's distinct (key, bias) pairs
of the rolled and pooled sets, as an exact softmax needs them (the
smallest exact count); "reference" counts every key of the reference's
formulation, as the plain reference computes them.

Bytes of a kernel: its inputs read once and its outputs written once, in
the compute dtype, whatever the kernel reads again.
"""

from functools import lru_cache

from reference import model as m
from reference.protocol import windows

PAD_MOD = (60, 108)
C = m.CHANNEL // 2
F32 = 4


def padded(h, w):
    return (-(-h // PAD_MOD[0]) * PAD_MOD[0], -(-w // PAD_MOD[1]) * PAD_MOD[1])


def conv(h, w, cin, cout, k, groups=1):
    """A stride-1-output conv's operations at an (h, w) output."""
    return 2 * h * w * cout * (cin // groups) * k * k


def encoder_flops(h, w):
    total = 0
    for cin, cout, s, g in m.ENC_PLAN:
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        total += conv(h, w, cin, cout, 3, g)
    return total


def spynet_flops(hs, ws):
    """One flow (one direction) between two (hs, ws) quarter frames."""
    hu, wu = -(-hs // 32) * 32, -(-ws // 32) * 32
    total = 0
    for level in range(m.SPYNET_LEVELS):
        div = 2 ** (m.SPYNET_LEVELS - 1 - level)
        for cin, cout in m.SPYNET_CHANNELS:
            total += conv(hu // div, wu // div, cin, cout, 7)
    return total


def decode_flops(hq, wq):
    total = 0
    h, w = hq, wq
    for up, cin, cout in m.DEC_PLAN:
        if up:
            h, w = 2 * h, 2 * w
        total += conv(h, w, cin, cout, 3)
    return total


def dcn_flops(hq, wq):
    """One DCN (K1) over one (hq, wq) frame: the 2304 x 128 contraction
    at every output pixel."""
    return 2 * hq * wq * C * (2 * C * 9)


def dcn_bytes(hq, wq, esize):
    """K1 over one frame: x (2C), the offset head (27 G), its two f32
    flows, the output (C); the weight is counted per launch."""
    return hq * wq * ((2 * C + 27 * m.DEFORM_GROUPS + C) * esize + 4 * F32)


def feat_prop_flops(nv, hq, wq):
    """Both propagation directions over nv local frames, and the fusion."""
    total = 0
    for d in range(2):
        back = conv(hq, wq, (2 + d) * C, C, 3) + conv(hq, wq, C, C, 3)
        offset = (conv(hq, wq, 3 * C + 4, C, 3) + 2 * conv(hq, wq, C, C, 3)
                  + conv(hq, wq, C, 27 * m.DEFORM_GROUPS, 3))
        total += nv * back + (nv - 1) * (offset + dcn_flops(hq, wq))
    return total + nv * conv(hq, wq, 2 * C, C, 1)


@lru_cache(maxsize=16)
def key_counts(lh, lw, keys):
    """Keys per frame of each window beyond its own tokens (the rolled and
    pooled sets), for an (lh, lw) token grid."""
    idx, bias = m.key_table(lh, lw)
    own = m.WINDOW[0] * m.WINDOW[1]
    if keys == "reference":
        return tuple(idx.shape[1] - own for _ in range(idx.shape[0]))
    if keys != "dedup":
        raise ValueError(f"keys {keys!r}")
    return tuple(len(set(zip(r[own:].tolist(), b[own:].tolist())))
                 for r, b in zip(idx, bias))


def attention_flops(t, lh, lw, keys):
    """One block's window attention over t frames: 4 nq nk hd a window and
    head (q k^T and p v)."""
    own = m.WINDOW[0] * m.WINDOW[1]
    hd = m.HIDDEN // m.NUM_HEADS
    nq = t * own
    return sum(4 * m.NUM_HEADS * nq * (t * (own + s)) * hd
               for s in key_counts(lh, lw, keys))


def attention_bytes(t, lh, lw, esize):
    """One block's K3 over t frames: q, the k and v token maps, the pooled
    k and v tokens, the output, and the f32 bias rows."""
    own = m.WINDOW[0] * m.WINDOW[1]
    nwin = (lh // m.WINDOW[0]) * (lw // m.WINDOW[1])
    tok = t * lh * lw * m.HIDDEN * esize
    pooled = t * nwin * m.HIDDEN * esize
    bias = sum(t * (own + s) for s in key_counts(lh, lw, "dedup")) * F32
    return 4 * tok + 2 * pooled + bias


def transformer_flops(t, n_out, hq, wq, variant, keys):
    lh, lw = m.token_grid((hq, wq))
    n = t * lh * lw
    npool = t * (lh // m.WINDOW[0]) * (lw // m.WINDOW[1])
    patch = C * 49
    own = m.WINDOW[0] * m.WINDOW[1]
    block = (2 * n * m.HIDDEN * 3 * m.HIDDEN          # qkv
             + 2 * npool * m.HIDDEN * 3 * m.HIDDEN    # pooled qkv
             + 2 * npool * m.HIDDEN * own             # window pooling
             + attention_flops(t, lh, lw, keys)
             + 2 * n * m.HIDDEN * m.HIDDEN            # proj
             + 4 * n * m.HIDDEN * m.D_FF)             # F3N fc1, fc2
    total = 2 * n * patch * m.HIDDEN + m.DEPTHS * block
    total += 2 * n_out * lh * lw * m.HIDDEN * patch   # soft comp
    if variant == "hq":
        total += n_out * conv(hq, wq, C, C, 3)
    return total


def video_work(variant, length, h, w, esize, max_batch, keys="dedup",
               stride=5, ref_length=10, num_ref=-1):
    """{model_flops, k1_flops, k1_bytes, k3_flops, k3_bytes} of one video
    of `length` frames at h x w, in a dtype of `esize` bytes, its windows
    batched max_batch at a time."""
    hp, wp = padded(h, w)
    hq, wq = hp // 4, wp // 4
    lh, lw = m.token_grid((hq, wq))
    plan = windows(length, stride, ref_length, num_ref)
    flops = length * encoder_flops(hp, wp)
    flops += 2 * (length - 1) * spynet_flops(hq, wq)
    k1_flops = k1_bytes = k3_flops = k3_bytes = 0
    for nb, refs in plan:
        nv, t = len(nb), len(nb) + len(refs)
        flops += feat_prop_flops(nv, hq, wq)
        flops += transformer_flops(t, nv, hq, wq, variant, keys)
        flops += nv * decode_flops(hq, wq)
        k1_flops += 2 * (nv - 1) * dcn_flops(hq, wq)
        k1_bytes += 2 * (nv - 1) * dcn_bytes(hq, wq, esize)
        k3_flops += m.DEPTHS * attention_flops(t, lh, lw, keys)
        k3_bytes += m.DEPTHS * attention_bytes(t, lh, lw, esize)
    weight = (C * 2 * C * 9 * esize + C * F32)
    for s in range(0, len(plan), max_batch):
        steps = max(len(nb) for nb, _ in plan[s: s + max_batch]) - 1
        k1_bytes += 2 * steps * weight
    return {"model_flops": flops, "k1_flops": k1_flops, "k1_bytes": k1_bytes,
            "k3_flops": k3_flops, "k3_bytes": k3_bytes}
