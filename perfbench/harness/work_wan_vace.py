"""The work a Wan2.1-VACE video needs, counted from the model's math: the
yardstick of the vace cell's roofline and MFU metrics, in harness/work.py's
terms (operations are multiply-adds times two of every convolution,
Linear and attention product, as torch's FlopCounterMode counts them; a
kernel's bytes are its inputs read once and its outputs written once).

A video of T = 1 + 4n frames is two VAE encodes (the inactive and the
reactive frames), `steps` x 2 DiT forwards (the prompt's and the negative
prompt's), each with its context blocks, and one VAE decode. A causal
convolution counts every output frame against its whole kernel, the zero
frames in front included, as the program's convolutions compute them.

`dit_attn` is the DiT's self-attention over all S tokens, the range
`perfbench.dit_attn`: 4 S^2 dim a call, q, k, v and o once each.
"""

import math


def conv(t, h, w, cin, cout, k):
    """A convolution's operations: t output frames of h x w, a kernel of
    k (a tuple of its sizes) taps."""
    return 2 * t * h * w * cout * cin * math.prod(k)


def _res(t, h, w, cin, cout):
    total = conv(t, h, w, cin, cout, (3, 3, 3)) \
        + conv(t, h, w, cout, cout, (3, 3, 3))
    return total + (conv(t, h, w, cin, cout, (1,)) if cin != cout else 0)


def _attn(t, h, w, c):
    n = h * w
    return t * (2 * n * 3 * c * c + 4 * n * n * c + 2 * n * c * c)


def vae_encode_flops(vae, t, h, w):
    dims = [vae["dim"] * u for u in [1] + list(vae["dim_mult"])]
    z2 = 2 * vae["z_dim"]
    total = conv(t, h, w, 3, dims[0], (3, 3, 3))
    last = len(vae["dim_mult"]) - 1
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(vae["num_res_blocks"]):
            total += _res(t, h, w, a, b)
            a = b
        if i != last:
            h, w = h // 2, w // 2
            total += conv(t, h, w, b, b, (3, 3))
            if vae["temperal_downsample"][i]:
                t_out = (t - 3) // 2 + 1
                total += conv(t_out, h, w, b, b, (3, 1, 1))
                t = 1 + t_out
    total += 2 * _res(t, h, w, b, b) + _attn(t, h, w, b)
    total += conv(t, h, w, b, z2, (3, 3, 3)) + conv(t, h, w, z2, z2, (1,))
    return total


def vae_decode_flops(vae, t, h, w):
    mult = list(vae["dim_mult"])
    dims = [vae["dim"] * u for u in [mult[-1]] + mult[::-1]]
    z = vae["z_dim"]
    ups = list(vae["temperal_downsample"])[::-1]
    total = conv(t, h, w, z, z, (1,)) + conv(t, h, w, z, dims[0], (3, 3, 3))
    total += 2 * _res(t, h, w, dims[0], dims[0]) + _attn(t, h, w, dims[0])
    last = len(mult) - 1
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        if i > 0:
            a //= 2
        for _ in range(vae["num_res_blocks"] + 1):
            total += _res(t, h, w, a, b)
            a = b
        if i != last:
            if ups[i]:
                total += conv(t - 1, h, w, b, 2 * b, (3, 1, 1))
                t = 1 + 2 * (t - 1)
            h, w = 2 * h, 2 * w
            total += conv(t, h, w, b, b // 2, (3, 3))
    return total + conv(t, h, w, b, 3, (3, 3, 3))


def _block_flops(s, dim, ffn, text_len):
    self_attn = 4 * 2 * s * dim * dim + 4 * s * s * dim
    cross = 2 * 2 * s * dim * dim + 2 * 2 * text_len * dim * dim \
        + 4 * s * text_len * dim
    return self_attn + cross + 2 * 2 * s * dim * ffn


def dit_forward_flops(dit, s):
    """One VaceWanModel forward over s tokens."""
    dim, ffn, L = dit["dim"], dit["ffn_dim"], dit["text_len"]
    p = math.prod(dit["patch_size"])
    n_ctx = len(dit["vace_layers"])
    total = 2 * s * dim * dit["in_dim"] * p \
        + 2 * s * dim * dit["vace_in_dim"] * p
    total += 2 * dit["freq_dim"] * dim + 2 * dim * dim + 2 * dim * 6 * dim
    total += 2 * L * dit["text_dim"] * dim + 2 * L * dim * dim
    total += 2 * s * dim * dim                          # before_proj
    total += (dit["num_layers"] + n_ctx) * _block_flops(s, dim, ffn, L)
    total += n_ctx * 2 * s * dim * dim                  # after_proj
    return total + 2 * s * dim * dit["out_dim"] * p


def tokens(dit, t, h, w):
    """The DiT's S for a clip of t frames of h x w pixels."""
    p = dit["patch_size"]
    return (1 + (t - 1) // 4) // p[0] * (h // 8 // p[1]) * (w // 8 // p[2])


def video_work(config, t, h, w, steps, esize):
    """{model_flops, dit_attn_flops, dit_attn_bytes} of one clip of t
    frames of h x w (multiples of 16; t = 1 + 4n) at `steps` steps;
    config {'dit': ..., 'vae': ...} as the configuration file has them."""
    dit, vae = config["dit"], config["vae"]
    s = tokens(dit, t, h, w)
    forwards = 2 * steps
    calls = forwards * (dit["num_layers"] + len(dit["vace_layers"]))
    model = 2 * vae_encode_flops(vae, t, h, w) \
        + forwards * dit_forward_flops(dit, s) \
        + vae_decode_flops(vae, 1 + (t - 1) // 4, h // 8, w // 8)
    return {"model_flops": model,
            "dit_attn_flops": calls * 4 * s * s * dit["dim"],
            "dit_attn_bytes": calls * 4 * s * dit["dim"] * esize}
