"""E3 and E4: the plain forms of row_gather and bilinear4_sample against
the JAX formulations of scripts/exp_gather.py, written here in jnp (the
script itself is not imported): E3 exact against take_along_axis, E4 to
1e-6 against the script's np_sample formula (:221-235).

The CUDA kernels' addressing (csrc/gather.cu) is emulated in torch on the
CPU and held to the same formulations: E3's blocks of `lanes` lanes (one
table read where a block's indices agree, one a lane where they do not,
0 outside [0, P)), and E4's read of the group-major table with its
shared-memory staging in lane order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2fgvi_tpu_torch.kernels import gather

torch.set_num_threads(2)
H, W, C, G, T = 6, 10, 32, 8, 3
P = H * W


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_row_gather_plain_matches_take_along_axis(dtype):
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((P, C)).astype(np.float32)
    idx = rng.integers(0, P, (T, P, C)).astype(np.int32)
    jtab = jnp.asarray(tab, jnp.bfloat16 if dtype == "bfloat16" else None)
    want = jnp.take_along_axis(jtab, jnp.asarray(idx).reshape(T * P, C),
                               axis=0).reshape(T, P, C)
    ttab = torch.from_numpy(tab)
    if dtype == "bfloat16":
        ttab = ttab.bfloat16()
    got = gather.row_gather(ttab, torch.from_numpy(idx))
    assert got.dtype == ttab.dtype and got.shape == (T, P, C)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _jnp_sample(tab, py, px):
    """The np_sample formula of scripts/exp_gather.py, in jnp float32, for
    any C (tab's lanes) and G (py's last axis) on the H x W map."""
    c, g = tab.shape[-1], py.shape[-1]
    pyl = jnp.tile(py, (1, 1, c // g))
    pxl = jnp.tile(px, (1, 1, c // g))
    y0 = jnp.clip(jnp.floor(pyl), 0, H - 2).astype(jnp.int32)
    x0 = jnp.clip(jnp.floor(pxl), 0, W - 2).astype(jnp.int32)
    wy0 = jnp.maximum(1 - jnp.abs(pyl - y0), 0)
    wy1 = jnp.maximum(1 - jnp.abs(pyl - y0 - 1), 0)
    wx0 = jnp.maximum(1 - jnp.abs(pxl - x0), 0)
    wx1 = jnp.maximum(1 - jnp.abs(pxl - x0 - 1), 0)
    lanes = jnp.arange(c)[None, None, :]
    return (tab[y0 * W + x0, lanes] * wy0 * wx0
            + tab[y0 * W + x0 + 1, lanes] * wy0 * wx1
            + tab[(y0 + 1) * W + x0, lanes] * wy1 * wx0
            + tab[(y0 + 1) * W + x0 + 1, lanes] * wy1 * wx1)


def test_bilinear4_plain_matches_jnp_formula():
    rng = np.random.default_rng(1)
    tab = rng.standard_normal((P, C)).astype(np.float32)
    # positions inside the map and past its edges (clamped corners)
    py = rng.uniform(-2, H + 1, (T, P, G)).astype(np.float32)
    px = rng.uniform(-2, W + 1, (T, P, G)).astype(np.float32)
    want = np.asarray(_jnp_sample(*map(jnp.asarray, (tab, py, px))))
    got = gather.bilinear4_sample(*map(torch.from_numpy, (tab, py, px)), H,
                                  W)
    assert got.shape == (T, P, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_bilinear4_lane_takes_group_j_mod_g():
    """Lane j reads group j % G: a table that is constant per lane and a
    position that differs per group show the map."""
    tab = torch.arange(C, dtype=torch.float32)[None, :].repeat(P, 1)
    py = torch.zeros((1, 1, G))
    px = torch.zeros((1, 1, G))
    px[0, 0, 3] = 0.25                     # group 3: weight 0.25 on x0+1
    got = gather.bilinear4_sample(tab, py, px, H, W)[0, 0]
    lanes = torch.arange(C, dtype=torch.float32)
    torch.testing.assert_close(got, lanes)   # every row holds the same
    tab2 = tab.clone()
    tab2[1] += 100.0                       # the (0, 1) corner differs
    got2 = gather.bilinear4_sample(tab2, py, px, H, W)[0, 0]
    torch.testing.assert_close(got2 - got,
                               torch.where(lanes % G == 3, 25.0, 0.0))


# ---------------------------------------------------------------------------
# E3's lane blocks (csrc/gather.cu row_gather_kernel), emulated
# ---------------------------------------------------------------------------

def _emulate_row_gather(tab, idx, lanes):
    """row_gather_kernel's addressing: vector v covers lanes j0 .. j0 +
    lanes of element offset v * lanes; one table read of the row where the
    block's indices agree and lie in [0, P), else one read a lane with 0
    outside. Returns (out, the number of blocks that took one read)."""
    p, c = tab.shape
    flat_idx = idx.reshape(-1)
    out = torch.empty(flat_idx.shape, dtype=tab.dtype)
    fast = 0
    for v in range(flat_idx.numel() // lanes):
        e, j0 = v * lanes, (v % (c // lanes)) * lanes
        r = flat_idx[e:e + lanes]
        if bool((r == r[0]).all()) and 0 <= int(r[0]) < p:
            out[e:e + lanes] = tab[int(r[0]), j0:j0 + lanes]
            fast += 1
        else:
            for i in range(lanes):
                ri = int(r[i])
                out[e + i] = tab[ri, j0 + i] if 0 <= ri < p else 0
    return out.reshape(idx.shape), fast


def _row_indices(case, rng, c):
    """(T, P, C) int32 indices: `shared` gives each 8-lane group one row
    (as a DCN's lanes of one group share one), `per_lane` a row a lane,
    `mixed` both in every row, `out_of_range` shared rows with some lanes
    and whole groups outside [0, P)."""
    per_lane = rng.integers(0, P, (T, P, c))
    shared = np.repeat(rng.integers(0, P, (T, P, c // 8 + 1)), 8,
                       axis=-1)[..., :c]
    if case == "per_lane":
        idx = per_lane
    elif case == "mixed":
        idx = np.where((np.arange(c) // 8) % 2 == 0, shared, per_lane)
    else:
        idx = shared
    if case == "out_of_range":
        idx = idx.copy()
        idx[:, ::3, 3] = -1                      # one lane of a group
        idx[:, 1::3, 8:16] = P                   # a whole group
        idx[:, 2::3, -1] = P + 7
    return idx.astype(np.int32)


# (index case, C, the lanes a thread takes): C = 20 takes 4 lanes
_ROW_CASES = {"shared": ("shared", 32, 8), "per_lane": ("per_lane", 32, 8),
              "mixed": ("mixed", 32, 8),
              "out_of_range": ("out_of_range", 32, 8),
              "c20": ("shared", 20, 4)}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("case", list(_ROW_CASES))
def test_row_gather_lane_blocks_match_take_along_axis(case, dtype):
    kind, c, lanes = _ROW_CASES[case]
    rng = np.random.default_rng(2)
    tab = rng.standard_normal((P, c)).astype(np.float32)
    idx = _row_indices(kind, rng, c)
    assert gather.row_lanes(c, 4, 256, 256) == lanes
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # 0 outside [0, P): the index of an appended zero row
    jtab = jnp.concatenate([jnp.asarray(tab, jdt), jnp.zeros((1, c), jdt)])
    safe = np.where((idx >= 0) & (idx < P), idx, P)
    want = jnp.take_along_axis(jtab, jnp.asarray(safe).reshape(-1, c),
                               axis=0).reshape(idx.shape)
    ttab = torch.from_numpy(tab)
    if dtype == "bfloat16":
        ttab = ttab.bfloat16()
    got, fast = _emulate_row_gather(ttab, torch.from_numpy(idx), lanes)
    blocks = idx.size // lanes
    if kind in ("shared", "mixed", "out_of_range"):
        assert 0 < fast
    if kind in ("per_lane", "mixed", "out_of_range"):
        assert fast < blocks
    if kind == "shared":
        assert fast == blocks
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# (C, element size, tab's and idx's byte offsets from a 256-byte aligned
# base, the lanes a thread takes)
_LANE_CASES = {"aligned_f32": (128, 4, 0, 0, 8),
               "aligned_bf16": (128, 2, 0, 0, 8),
               "c20": (20, 4, 0, 0, 4),
               "c6_bf16": (6, 2, 0, 0, 2),
               "c5": (5, 4, 0, 0, 1),
               "tab_view_f32": (128, 4, 4, 0, 1),
               "tab_view_8_bytes": (128, 4, 8, 0, 2),
               "tab_view_bf16": (128, 2, 2, 0, 1),
               "tab_view_bf16_8_bytes": (128, 2, 8, 0, 4),
               "idx_view": (128, 2, 0, 4, 1),
               "idx_view_8_bytes": (128, 4, 0, 8, 2)}


@pytest.mark.parametrize("case", list(_LANE_CASES))
def test_row_lanes_takes_the_widest_aligned_load(case):
    c, esize, tab_off, idx_off, lanes = _LANE_CASES[case]
    assert gather.row_lanes(c, esize, 256 + tab_off, 512 + idx_off) == lanes


# ---------------------------------------------------------------------------
# E4's group-major table and staged sampler (csrc/gather.cu), emulated
# ---------------------------------------------------------------------------

def _stage_rows(g, c):
    """Rows a sampler block stages: as many rows as fill 256 threads (C/4
    threads a row where C/G % 4 == 0, else G) within 48 KB of rows padded
    by 16 floats."""
    per_row = c // 4 if (c // g) % 4 == 0 else g
    return max(1, min(256 // per_row, 48 * 1024 // (4 * (c + 16))))


def _emulate_bilinear4(tab, py, px, h, w):
    """bilinear4_group_major_kernel on group_major_plain's table: each
    (row, group) computes its corners and weights, reads each corner's C/G
    channels as one run of the group's plane (in 4-channel pieces, one a
    thread, where C/G % 4 == 0: the same values), sums in the kernel's
    order in float32 and writes lane k*G + g of a padded staging row; the
    block's staged rows then go out in lane order."""
    c, (t, p, g) = tab.shape[-1], py.shape
    cg, rows = c // g, t * p
    tabg = gather.group_major_plain(tab, g)                 # (G, h*w, CG)
    fy, fx = py.reshape(rows, g), px.reshape(rows, g)
    y0 = torch.clamp(torch.floor(fy), 0.0, float(h - 2))
    x0 = torch.clamp(torch.floor(fx), 0.0, float(w - 2))
    wy0 = torch.clamp(1.0 - (fy - y0).abs(), min=0.0)
    wy1 = torch.clamp(1.0 - (fy - (y0 + 1.0)).abs(), min=0.0)
    wx0 = torch.clamp(1.0 - (fx - x0).abs(), min=0.0)
    wx1 = torch.clamp(1.0 - (fx - (x0 + 1.0)).abs(), min=0.0)
    pix = y0.long() * w + x0.long()                         # (rows, G)
    grp = torch.arange(g)[None, :]

    def corner(off):                                        # (rows, G, CG)
        return tabg[grp, pix + off]

    acc = corner(0) * (wy0 * wx0)[..., None]
    acc = acc + corner(1) * (wy0 * wx1)[..., None]
    acc = acc + corner(w) * (wy1 * wx0)[..., None]
    acc = acc + corner(w + 1) * (wy1 * wx1)[..., None]
    rb = _stage_rows(g, c)
    out = torch.empty((rows, c))
    for row0 in range(0, rows, rb):
        nr = min(rb, rows - row0)
        stage = torch.full((rb, c + 16), float("nan"))
        for k in range(cg):
            stage[:nr, k * g + torch.arange(g)] = acc[row0:row0 + nr, :, k]
        out[row0:row0 + nr] = stage[:nr, :c]
    return out.reshape(t, p, c)


# (C, G): C/G = 8 (16-byte corner loads), 3 (scalar loads)
_GROUP_CASES = {"cg8": (32, 4), "cg3": (24, 8)}


@pytest.mark.parametrize("case", list(_GROUP_CASES))
def test_group_major_plain_reorders_lanes(case):
    c, g = _GROUP_CASES[case]
    tab = np.random.default_rng(3).standard_normal((P, c)).astype(np.float32)
    got = gather.group_major_plain(torch.from_numpy(tab), g).numpy()
    assert got.shape == (g, P, c // g)
    gi, pi, ki = np.meshgrid(np.arange(g), np.arange(P), np.arange(c // g),
                             indexing="ij")
    np.testing.assert_array_equal(got, tab[pi, ki * g + gi])


@pytest.mark.parametrize("case", list(_GROUP_CASES))
def test_bilinear4_group_major_emulation_matches_jnp_formula(case):
    c, g = _GROUP_CASES[case]
    rng = np.random.default_rng(4)
    tab = rng.standard_normal((P, c)).astype(np.float32)
    # a ragged row count (T * 37 rows against blocks of 64 or 32) and
    # positions past the map's edges (clamped corners)
    py = rng.uniform(-2, H + 1, (T, 37, g)).astype(np.float32)
    px = rng.uniform(-2, W + 1, (T, 37, g)).astype(np.float32)
    assert (T * 37) % _stage_rows(g, c)
    want = np.asarray(_jnp_sample(*map(jnp.asarray, (tab, py, px))))
    got = _emulate_bilinear4(*map(torch.from_numpy, (tab, py, px)), H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    plain = gather.bilinear4_sample(*map(torch.from_numpy, (tab, py, px)),
                                    H, W)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-6)
