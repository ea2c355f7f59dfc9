"""E1, E5, E6: the banded DCN sampler's variants, wrappers and plain forms.

Counterpart of the TPU experiment kernels of scripts/exp_dcn_inner_r04.py
(E5 `base`, `bf16` and `cbatch` at :83, :122, :161; E6 `packed` at :201)
and scripts/exp_dcn_pack.py (E1 `_packed_kernel` at :39). The CUDA
kernels are in csrc/band_sampler.cu. All of them compute the TPU sampler's
function (e2fgvi_tpu/kernels/dcn_band.py:_sampler_kernel, light form):

    out[i,t,c,y,x] = mask * sum_{r in [0, band)} relu(1 - |py - (y+dy_lo+r)|)
                     * (wx0 * src[i,c,y+r,x0] + wx1 * src[i,c,y+r,x0+1])
    x0 = clip(floor(px), 0, WP-2)
    wx0 = relu(1 - |px - x0|), wx1 = relu(1 - |px - x0 - 1|)

src is (NG, CG, HP+band, WP): slab row y+r holds image row y+dy_lo+r.
py/px/mask are (NG, K, HP, WP) float32; out is (NG, K, CG, HP, WP). Only
rows floor(py) and floor(py)+1 have a nonzero weight, and each counts only
when its band index lies in [0, band); the plain forms and the kernels add
just those two, which for finite inputs equals the sweep.

Roundings: `band_sample` writes bf16(acc) * bf16(mask) for a bfloat16
output (the TPU's `acc.astype(bf16) * mask.astype(bf16)`) and acc * mask
for float32; `band_sample_cbatch` writes one rounding, bf16(acc * mask).

Packed sources, 32-bit words stored as int32 (bit patterns are what
matter; torch's uint32 has few operations):
  pack_xpairs (E6): word = bf16 src[..., x] << 16 | bf16 src[..., x+1],
      with a zero after the last column (dcn_band._pack_pairs).
  pack_cpairs (E1): word c = bf16 channel 2c in the low half, channel
      2c+1 in the high half.

E5, E6 and E1 run one staged kernel (csrc/band_sampler.cu
band_staged_kernel): a block per (i, y-tile) for all taps and channels, the
tile's slab rows copied into shared memory by channel chunk (E1: by chunk
of channel-pair words). `plan` picks the tile height and the chunk; a shape
it cannot fit raises ValueError.

Each wrapper takes its plain version for tensors on the CPU, and only then;
for CUDA tensors it launches its kernel or raises. Kernels are
forward-only. `LAUNCHES` counts each wrapper's launches.
"""

import functools
from typing import NamedTuple

import torch

from e2fgvi_tpu_torch.kernels import build
from e2fgvi_tpu_torch.kernels.deform import check_cuda_inputs

LAUNCHES = {"band_sample": 0, "band_sample_cbatch": 0,
            "band_sample_xpair": 0, "band_sample_cpair": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# ---------------------------------------------------------------------------
# The staged kernel's plan
# ---------------------------------------------------------------------------

# dynamic shared memory a block may use: 227 KB less the kernel's two
# mbarriers (csrc/band_sampler.cu band::kMaxSmem)
SMEM_MAX = 232448 - 16
# what two blocks can hold on one SM (228 KB, 1 KB reserved a block)
SMEM_TWO_BLOCKS = (233472 - 2 * 1024) // 2 - 16
# output rows a block: 8 or 4, smaller only where nothing else fits
TILE_ROWS = (8, 4, 2, 1)
# L2 bytes an output past which a plan's L2 traffic, not its occupancy,
# sets its pace: on the H100 the two-block plans of 4-byte elements at
# band 48 read 11.7 and ran at ~3.5 TB/s through L2, 10-24% behind one
# block reading 6.1 (tools/band_plan_sweep.py); at 3.1-6.0 two blocks won
L2_BYTES_PER_OUTPUT = 8


class BandPlan(NamedTuple):
    """How the staged kernel cuts one call: blocks of `ty` output rows of
    one (batch, group) tile i, all taps and channels; the block stages its
    slab rows in shared memory `chunk` channels at a time, `slot_bytes` a
    channel, double-buffered when there is more than one chunk."""
    ty: int
    chunk: int
    nchunks: int
    slot_bytes: int
    smem_bytes: int

    def tiles(self, hp, band):
        """(y0, output rows, staged slab rows) of each y-tile: the block
        writes rows [y0, y0 + output rows) and stages slab rows [y0, y0 +
        staged rows), which holds every row a tap inside the band reaches
        (y + r for r in [0, band))."""
        for y0 in range(0, hp, self.ty):
            tyn = min(self.ty, hp - y0)
            yield y0, tyn, min(tyn + band - 1, hp + band - y0)


def _slot_bytes(ty, band, wp, esize):
    """Shared bytes of one channel's staged rows (band::slot_bytes): rows
    padded by 16 bytes where the row pitch is a multiple of 16 (the
    padding spreads the corners of random rows over the banks), else the
    contiguous run rounded up to 16, plus 16 for the shift that lines it up
    with its global address."""
    rows, row_bytes = ty + band - 1, wp * esize
    if row_bytes % 16 == 0:
        return rows * (row_bytes + 16)
    return -(-rows * row_bytes // 16) * 16 + 16


def make_plan(ty, chunk, cg, wp, band, esize):
    """The BandPlan of a tile height and a channel chunk."""
    nchunks = -(-cg // chunk)
    slot = _slot_bytes(ty, band, wp, esize)
    return BandPlan(ty, chunk, nchunks, slot,
                    (1 if nchunks == 1 else 2) * chunk * slot)


def _l2_bytes(p, k, cg, hp, wp, band, esize):
    """Bytes a plan reads through L2 for one (batch, group) tile i beside
    its output: the positions and mask once a chunk, and each y-tile's
    staged rows of every channel."""
    staged = sum(rows for _, _, rows in p.tiles(hp, band))
    return p.nchunks * k * hp * wp * 12 + staged * cg * wp * esize


@functools.lru_cache(maxsize=256)      # the wrappers plan every launch
def plan(cg, hp, wp, band, esize, k=9):
    """The staged kernel's plan for CG channels of (HP + band, WP) slabs of
    `esize`-byte elements (4: float32 or packed x-pairs, 2: bfloat16) and
    K taps (K1's 3x3 by default).

    Tiles of 8 or 4 output rows (2 or 1 only where neither fits) and
    equal channel chunks, scored by the bytes they read through L2
    (positions once a chunk, slab rows once a tile; the taller tile on a
    tie). The least of those that let two blocks share an SM, unless it
    reads more than L2_BYTES_PER_OUTPUT: then the least of all, up to the
    227 KB one block may use. Raises ValueError where not even one channel
    of one output row fits."""
    tys = list(dict.fromkeys(min(t, hp) for t in TILE_ROWS))
    chunks = sorted({-(-cg // n) for n in range(1, cg + 1)})
    for heights in (tys[:2], tys[2:]):
        fits = [p for p in (make_plan(ty, c, cg, wp, band, esize)
                            for ty in heights for c in chunks)
                if p.smem_bytes <= SMEM_MAX]
        if not fits:
            continue
        cost = {p: _l2_bytes(p, k, cg, hp, wp, band, esize) for p in fits}
        order = sorted(fits, key=lambda p: (cost[p], -p.ty))
        two = [p for p in order if p.smem_bytes <= SMEM_TWO_BLOCKS]
        if two and cost[two[0]] <= L2_BYTES_PER_OUTPUT * k * cg * hp * wp:
            return two[0]
        return order[0]
    raise ValueError(f"band sampler: no plan fits {SMEM_MAX} bytes of "
                     f"shared memory (CG {cg}, HP {hp}, WP {wp}, band "
                     f"{band}, {esize}-byte elements)")


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_xpairs(src):
    """(..., W) bfloat16 -> (..., W) int32: src[x] << 16 | src[x+1], zero
    after the last column. One 32-bit load then gives both x corners."""
    if src.dtype != torch.bfloat16:
        raise ValueError(f"pack_xpairs: needs bfloat16, got {src.dtype}")
    nxt = torch.cat([src[..., 1:], torch.zeros_like(src[..., :1])], -1)
    # little-endian: element 0 of the pair is the word's low half
    return torch.stack([nxt, src], -1).view(torch.int32).squeeze(-1)


def unpack_xpairs(psrc):
    """Inverse of pack_xpairs: the bfloat16 src in each word's high half."""
    return psrc.unsqueeze(-1).view(torch.bfloat16)[..., 1]


def pack_cpairs(src):
    """(NG, CG, H, W) bfloat16 -> (NG, CG/2, H, W) int32: channel 2c in the
    low half, channel 2c+1 in the high half. One load gives two channels."""
    if src.dtype != torch.bfloat16 or src.shape[1] % 2:
        raise ValueError("pack_cpairs: needs bfloat16 with an even channel "
                         f"count, got {src.dtype} {tuple(src.shape)}")
    ng, cg, h, w = src.shape
    pairs = src.reshape(ng, cg // 2, 2, h, w).permute(0, 1, 3, 4, 2)
    return pairs.contiguous().view(torch.int32).squeeze(-1)


def unpack_cpairs(psrc):
    """Inverse of pack_cpairs."""
    ng, cgp, h, w = psrc.shape
    pairs = psrc.unsqueeze(-1).view(torch.bfloat16)
    return pairs.permute(0, 1, 4, 2, 3).reshape(ng, 2 * cgp, h, w)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _band_acc(src, py, px, dy_lo):
    """The float32 sum before the mask: (NG, K, CG, HP, WP)."""
    ng, cg, hs, wp = src.shape
    _, k, hp, _ = py.shape
    band = hs - hp
    py, px = py.float(), px.float()
    y = torch.arange(hp, dtype=torch.float32, device=src.device)[:, None]
    x0f = torch.clamp(torch.floor(px), 0, wp - 2)
    wx0 = torch.relu(1.0 - (px - x0f).abs())
    wx1 = torch.relu(1.0 - (px - (x0f + 1.0)).abs())
    x0 = x0f.long()
    flat = src.reshape(ng, 1, cg, hs * wp)
    acc = None
    for step in (0.0, 1.0):
        yr = torch.floor(py) + step                   # image row
        r = yr - (y + dy_lo)                          # its band index
        ok = (r >= 0) & (r < band)
        wy = torch.where(ok, torch.relu(1.0 - (py - yr).abs()), 0.0)
        row = torch.where(ok, r, 0.0).long() + y.long()
        base = (row * wp + x0).reshape(ng, k, 1, hp * wp)
        base = base.expand(ng, k, cg, hp * wp)
        src_k = flat.expand(ng, k, cg, hs * wp)
        g0 = src_k.gather(3, base).float()
        g1 = src_k.gather(3, base + 1).float()
        w0 = (wy * wx0).reshape(ng, k, 1, hp * wp)
        w1 = (wy * wx1).reshape(ng, k, 1, hp * wp)
        term = g0 * w0 + g1 * w1
        acc = term if acc is None else acc + term
    return acc.reshape(ng, k, cg, hp, wp)


def band_sample_plain(src, py, px, mask, dy_lo, out_dtype=None):
    """Plain version of E5 `base`/`bf16` (and of E1, E6 after unpacking).

    out_dtype (default src's): bfloat16 gives bf16(acc) * bf16(mask),
    float32 gives acc * mask."""
    out_dtype = out_dtype or src.dtype
    acc = _band_acc(src, py, px, dy_lo)
    m = mask.float()[:, :, None]
    if out_dtype == torch.bfloat16:
        return acc.to(torch.bfloat16) * m.to(torch.bfloat16)
    return (acc * m).to(out_dtype)


def band_sample_cbatch_plain(src, py, px, mask, dy_lo):
    """Plain version of E5 `cbatch`: one rounding, (acc * mask) in src's
    dtype."""
    acc = _band_acc(src, py, px, dy_lo)
    return (acc * mask.float()[:, :, None]).to(src.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, src, py, px, mask):
    """Validate a launch; returns (NG, K, CG, HP, WP, band)."""
    check_cuda_inputs(name, src, py, px, mask)
    if src.dim() != 4 or py.dim() != 4:
        raise ValueError(f"{name}: src must be (NG, CG, HS, WP) and py "
                         "(NG, K, HP, WP)")
    ng, cg, hs, wp = src.shape
    _, k, hp, _ = py.shape
    if (py.shape[0] != ng or py.shape[3] != wp or px.shape != py.shape
            or mask.shape != py.shape):
        raise ValueError(f"{name}: shapes do not agree: src "
                         f"{tuple(src.shape)}, py {tuple(py.shape)}, px "
                         f"{tuple(px.shape)}, mask {tuple(mask.shape)}")
    if any(t.dtype != torch.float32 for t in (py, px, mask)):
        raise ValueError(f"{name}: py, px and mask must be float32")
    if hs <= hp or wp < 2:
        raise ValueError(f"{name}: need HS > HP and WP >= 2")
    return ng, k, cg, hp, wp, hs - hp


def _prep(src, py, px, mask):
    return (src.contiguous(), py.contiguous(), px.contiguous(),
            mask.contiguous())


def _vx(wp, esize, lanes, *tensors):
    """Consecutive x a thread of the staged kernel takes: 8 for 4-byte
    source elements of one channel, 4 for bfloat16 and for channel pairs
    (`lanes` 2: 8 outputs an x group, as E5's bfloat16 at 4), where WP
    allows and the position and output rows are 16-byte aligned; else 4,
    else 1."""
    for vx in (8, 4) if esize == 4 and lanes == 1 else (4,):
        if wp % vx == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
            return vx
    return 1


def _launch_staged(name, entry, lead, src, py, px, mask, dy_lo, out_dtype,
                   lanes=1):
    """Check, plan and launch the staged kernel through the C entry point
    `entry` (`lead`: its arguments before the pointers); `lanes`: output
    channels a source element holds (2 for channel-pair words). Returns the
    output."""
    ng, k, cg, hp, wp, band = _check(name, src, py, px, mask)
    p = plan(cg, hp, wp, band, src.element_size(), k)
    out = torch.empty((ng, k, lanes * cg, hp, wp), dtype=out_dtype,
                      device=src.device)
    err = getattr(build.library(), entry)(
        *lead, src.data_ptr(), py.data_ptr(), px.data_ptr(), mask.data_ptr(),
        out.data_ptr(), ng, k, cg, hp, wp, band, dy_lo, p.ty, p.chunk,
        _vx(wp, src.element_size(), lanes, py, px, mask, out),
        *build.stream_args(src))
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def band_sample(src, py, px, mask, dy_lo, out_dtype=None):
    """E5 `base` / `bf16`.

    src float32 or bfloat16; out_dtype defaults to src's. float32 src with
    a bfloat16 output is E5 `base` (float32 gathers); bfloat16 src is E5
    `bf16` (bfloat16 gathers). Both write bf16(acc) * bf16(mask)."""
    out_dtype = out_dtype or src.dtype
    if src.device.type == "cpu":
        return band_sample_plain(src, py, px, mask, dy_lo, out_dtype)
    src, py, px, mask = _prep(src, py, px, mask)
    if (src.dtype, out_dtype) not in ((torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.float32, torch.bfloat16)):
        raise ValueError(f"band_sample: src {src.dtype} with output "
                         f"{out_dtype} is not a kernel")
    return _launch_staged("band_sample", "e2fgvi_band_sample",
                          (_DTYPES[src.dtype], _DTYPES[out_dtype]), src, py,
                          px, mask, dy_lo, out_dtype)


def band_sample_cbatch(src, py, px, mask, dy_lo):
    """E5 `cbatch`: the row and x weights once per position, a loop over
    the channels; writes (acc * mask) rounded once to src's dtype (float32
    or bfloat16)."""
    if src.device.type == "cpu":
        return band_sample_cbatch_plain(src, py, px, mask, dy_lo)
    src, py, px, mask = _prep(src, py, px, mask)
    if src.dtype not in _DTYPES:
        raise ValueError(f"band_sample_cbatch: unsupported {src.dtype}")
    return _launch_staged("band_sample_cbatch", "e2fgvi_band_sample_cbatch",
                          (_DTYPES[src.dtype],), src, py, px, mask, dy_lo,
                          src.dtype)


def band_sample_xpair(psrc, py, px, mask, dy_lo):
    """E6: psrc from pack_xpairs, (NG, CG, HS, WP) int32; one 32-bit load
    per (channel, row) gives both x corners. bfloat16 output, bit-equal
    to band_sample on the unpacked bfloat16 src."""
    if psrc.device.type == "cpu":
        return band_sample_plain(unpack_xpairs(psrc), py, px, mask, dy_lo)
    psrc, py, px, mask = _prep(psrc, py, px, mask)
    if psrc.dtype != torch.int32:
        raise ValueError("band_sample_xpair: psrc must be int32 "
                         "(pack_xpairs)")
    return _launch_staged("band_sample_xpair", "e2fgvi_band_sample_xpair", (),
                          psrc, py, px, mask, dy_lo, torch.bfloat16)


def band_sample_cpair(psrc, py, px, mask, dy_lo):
    """E1: psrc from pack_cpairs, (NG, CG/2, HS, WP) int32; the staged
    kernel on channel-pair words (planned as CG/2 channels of 4 bytes), one
    32-bit shared load per corner and row gives two channels. Writes
    channels 2c and 2c+1 in bfloat16, bit-equal to band_sample on the
    unpacked bfloat16 src."""
    if psrc.device.type == "cpu":
        return band_sample_plain(unpack_cpairs(psrc), py, px, mask, dy_lo)
    psrc, py, px, mask = _prep(psrc, py, px, mask)
    if psrc.dtype != torch.int32:
        raise ValueError("band_sample_cpair: psrc must be int32 "
                         "(pack_cpairs)")
    return _launch_staged("band_sample_cpair", "e2fgvi_band_sample_cpair",
                          (), psrc, py, px, mask, dy_lo, torch.bfloat16,
                          lanes=2)
