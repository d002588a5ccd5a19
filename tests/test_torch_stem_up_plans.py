"""The launch plans and the tiling of kernel F's deploy form
(``csrc/fused_stems.cu::stem_mma_kernel``) and of kernel H's fused
transposed + 1x1x1 conv (``csrc/fused_hourglass.cu::up_cat_mma_kernel``),
on the CPU.

``stem_plan`` and ``up_plan`` are held on every StemBlock and up level of
L, M and S on a 544 x 992 frame: an instance of the kernel covers each,
its shared memory is the kernel's own count (``stem_smem``, ``up_smem``,
recounted here region by region) and lets two blocks share an SM, and the
Python instance lists are the sources' X-lists. Each kernel's index math
(the tile origins, the halo and the stride-2 window with its even columns
first, stem_2's im2col rows, the parity classes and their taps, the skip
tile's rows, the swizzle, the ldmatrix and mma fragments, the output
stores) is written out below in numpy, line for line with the source, on
float64 values with the epilogues left out, and held against ``F.conv2d``
and ``F.conv_transpose3d`` + ``F.conv3d`` at tiny ragged shapes. Shared
memory starts as NaN, so a read of a byte the kernel never stages shows.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.models.esmstereo import ESMStereoConfig, conv3d_shapes
from esmstereo_tpu_torch.ops.kernels import fused_hourglass as fh
from esmstereo_tpu_torch.ops.kernels import fused_stems as fs

CSRC = Path(__file__).resolve().parents[1] / "esmstereo_tpu_torch" / "csrc"
CONFIGS = {"L": ESMStereoConfig(), "M": ESMStereoConfig(cv_scale=8),
           "S": ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100")}
FRAME = (544, 992)
SM_SMEM = 233472          # an H100 SM's shared memory, 1 KB a block reserved


def cdiv(a, b):
    return -(-a // b)


def up_levels(config):
    """(ci, co, ds, hs, ws, d2, h2, w2) of the hourglass's two up levels."""
    downs = [(co, *((n - 1) // 2 + 1 for n in (d, h, w)))
             for _, ci, co, d, h, w, s in conv3d_shapes(config, *FRAME)
             if s == 2]
    return [(*downs[2][:1], *downs[1][:1], *downs[2][1:], *downs[1][1:]),
            (*downs[1][:1], *downs[0][:1], *downs[1][1:], *downs[0][1:])]


UP_CASES = [pytest.param(*shape, id=f"{var} level {k}")
            for var, config in CONFIGS.items()
            for k, shape in enumerate(up_levels(config), start=1)]
STEM_CASES = [(3, 32), (32, 48), (3, 16), (16, 24)]


def up_bytes(nt, th, td):
    """up_cat_mma_kernel's shared memory, region by region."""
    slab = (td + 2) * (th + 2) * (16 + 2) * 16 * 2     # one chunk, bf16
    weights = 4 * 4 * 4 * 8 * nt * 16 * 2              # [64 taps][n][16]
    skip = cdiv(nt, 2) * (8 * th * td * 16) * 16 * 2   # [chunk][voxel][16]
    cat = 2 * cdiv(nt, 2) * 8 * nt * 16 * 2            # [2 chunks][n][16]
    return max(slab + weights, skip + cat)


def stem_bytes(ci, c, th, tw, form="bf16"):
    """stem_mma_kernel's shared memory, region by region: rows of 32
    bytes, 16 bf16 or 8 fp32 channels; in the deploy form the conv's
    weights beside the window's region, in the fp32 form (each weight as
    two TF32 planes, high and low) through it."""
    kc, es, wb = (16, 2, 1) if form == "bf16" else (8, 4, 2)
    np_, chunks = 8 * cdiv(c, 8), cdiv(c, kc)
    halo = (th + 2) * (tw + 2)
    mid = chunks * halo * 32
    if ci == 3:
        down = 32 // kc * halo * 32 + wb * 32 // kc * np_ * 32
    else:
        down = (2 * th + 5) * (2 * tw + 5) * 32 + wb * 9 * np_ * 32
    region = max(down, np_ * (th * tw + 8) * es)
    if form == "bf16":
        return mid + region + chunks * 9 * np_ * 32
    return mid + max(region, wb * 9 * np_ * 32)


@pytest.mark.parametrize("ci,co,ds,hs,ws,d2,h2,w2", UP_CASES)
def test_up_plan(ci, co, ds, hs, ws, d2, h2, w2):
    plan = fh.up_plan(ci, co, ds, hs, ws, d2, h2, w2)
    th, td = plan.tile
    assert (plan.n_tiles, th, td) in fh.UP_INSTANCES
    assert plan.n_tiles == cdiv(co, 8)
    assert plan.smem == up_bytes(plan.n_tiles, th, td)
    assert 2 * (plan.smem + 1024) <= SM_SMEM
    assert plan.blocks == cdiv(w2, 32) * cdiv(h2, 2 * th) * cdiv(d2, 2 * td)
    # the largest tile within the warp's sums whose grid holds 3/4 of the
    # card's SMs, else the smallest
    tiles = [t for t in fh.UP_TILES
             if t[0] * t[1] * plan.n_tiles <= fh.UP_MAX_SUMS]
    filled = [t for t in tiles
              if cdiv(w2, 32) * cdiv(h2, 2 * t[0]) * cdiv(d2, 2 * t[1])
              >= 3 * fh.SMS // 4]
    assert plan.tile == (filled[0] if filled else tiles[-1])
    ints = list(plan.ints(1, True))
    assert ints == [1, ci, co, ds, hs, ws, d2, h2, w2, plan.n_tiles, th, td,
                    plan.smem, 1]


def test_up_plan_refuses():
    with pytest.raises(ValueError, match="n-tiles"):
        fh.up_plan(40, 72, 3, 9, 16, 6, 17, 31)       # 9 n-tiles
    with pytest.raises(ValueError):
        fh.up_plan(40, 24, 3, 9, 16, 7, 17, 31)       # d2 > 2 ds
    with pytest.raises(ValueError, match="no instance"):
        fh.up_layout(72, 40, 6, 17, 31, 12, 34, 62, (2, 2))


@pytest.mark.parametrize("ci,c", STEM_CASES)
def test_stem_plan(ci, c):
    plan = fs.stem_plan(ci, c)
    th, tw = plan.tile
    assert plan.tile == fs.STEM_TILES[("bf16", ci, c)]
    assert ("bf16", ci, c, th, tw) in fs.STEM_INSTANCES
    assert plan.smem == stem_bytes(ci, c, th, tw)
    assert 2 * (plan.smem + 1024) <= SM_SMEM
    assert tw % 16 == 0 and th * tw % 128 == 0
    with pytest.raises(ValueError, match="no instance"):
        fs.stem_plan(ci, c + 8)


def test_instances_match_the_sources_and_the_models():
    """The X-lists of ``STEM_INSTANCES`` (fused_stems.cu) and
    ``UP_INSTANCES`` (fused_hourglass.cu) are the Python lists, and those
    cover every StemBlock and up level of L, M and S."""
    def x_list(source, name, arity, token=False):
        text = (CSRC / source).read_text()
        block = text[text.index(f"#define {name}(X)"):]
        block = block[:block.index("\n\n")]
        fields = [r"(\w+)"] * token + [r"(\d+)"] * arity
        found = re.findall(r"X\(" + ", ".join(fields) + r"\)", block)
        return [tuple(v if i < token else int(v) for i, v in enumerate(f))
                for f in found]

    stems = x_list("fused_stems.cu", "STEM_INSTANCES", 4, token=True)
    assert len(stems) == len(set(stems)) and set(stems) == fs.STEM_INSTANCES
    ups = x_list("fused_hourglass.cu", "UP_INSTANCES", 3)
    assert len(ups) == len(set(ups)) and set(ups) == fh.UP_INSTANCES
    widths = {(3, c2) for c2, _ in fs.WIDTHS} | set(fs.WIDTHS)
    assert set(fs.STEM_TILES) == {(form, *w) for form in fs.FORMS
                                  for w in widths}
    for config in CONFIGS.values():
        for shape in up_levels(config):
            plan = fh.up_plan(*shape)
            assert (plan.n_tiles, *plan.tile) in fh.UP_INSTANCES


# --- the kernels' index math, in numpy ---------------------------------------

LANE = np.arange(32)
A_ROW, A_HALF = (LANE & 7) + ((LANE >> 3) & 1) * 8, LANE >> 4
B_N, B_HALF = (LANE & 7) + ((LANE >> 4) << 3), (LANE >> 3) & 1


def swz(row, half):
    """conv3d.cuh::swz: byte offset of a 16-byte half of a 32-byte row."""
    return row * 32 + ((half ^ ((row >> 2) & 1)) << 4)


def store(smem, dst, vals, es=2):
    """16-byte stores: vals (..., 16 / es) of es bytes each at byte offsets
    dst (...); smem holds one value every es bytes."""
    assert (dst % 16 == 0).all()
    smem[dst[..., None] // es + np.arange(16 // es)] = vals


def a_tiles(smem, addr, es=2):
    """ldmatrix.x4 as mma's A: lane addresses (..., 32) -> (..., 16, k),
    lane l giving row A_ROW[l], values n A_HALF[l] .. + n - 1 (n = 16 /
    es): the m16n8k16 bf16 fragment (k 16), or the m16n8k8 tf32 one (k 8:
    ldmatrix hands lane l the 32-bit word l % 4 of row l / 4)."""
    assert (addr % 16 == 0).all()
    n = 16 // es
    rows = smem[addr[..., None] // es + np.arange(n)]
    out = np.empty((*addr.shape[:-1], 16, 2 * n))
    out[..., A_ROW[:, None], A_HALF[:, None] * n + np.arange(n)] = rows
    return out


def b_tiles(smem, base, row0, nt, es=2):
    """``load_b``: B (k, 8 nt n) from rows row0 + n of a [row][k] layout
    (k 16 bf16 or 8 fp32), ldmatrix.x4 a pair of n-tiles, .x2 (lanes 0-15)
    the last."""
    n = 16 // es
    out = np.empty((2 * n, 8 * nt))
    for j in range(0, nt - 1, 2):
        rows = smem[(base + swz(row0 + j * 8 + B_N, B_HALF))[:, None] // es
                    + np.arange(n)]
        out[B_HALF[:, None] * n + np.arange(n), j * 8 + B_N[:, None]] = rows
    if nt % 2:
        ln = LANE[:16]
        rows = smem[(base + swz(row0 + (nt - 1) * 8 + (ln & 7),
                                B_HALF[:16]))[:, None] // es + np.arange(n)]
        out[B_HALF[:16, None] * n + np.arange(n),
            (nt - 1) * 8 + (ln & 7)[:, None]] = rows
    return out


def up_cat_emulated(src, skip, wu, wc, tile):
    """up_cat_mma_kernel's sums on float64 values, its BN, GELU and bf16
    roundings left out: z = wc [up | skip] with up the cropped transposed
    conv."""
    b_, ci, ds, hs, ws = src.shape
    co, d2, h2, w2 = skip.shape[1:]
    th, td = tile
    nt = cdiv(co, 8)
    np_, ck, mt_n = 8 * nt, cdiv(nt, 2), th * td
    sd, sh, sw = td + 2, th + 2, 18
    nvox = sd * sh * sw
    voxels = 8 * mt_n * 16
    slab_bytes = nvox * 32
    wflat = wu.reshape(ci, co, 64)
    tiles_w, tiles_h = cdiv(w2, 32), cdiv(h2, 2 * th)
    z = np.full((b_, co, d2, h2, w2), np.nan)
    m = np.arange(mt_n)
    for b in range(b_):
        for tile_ in range(tiles_w * tiles_h * cdiv(d2, 2 * td)):
            tw0 = tile_ % tiles_w * 16
            th0 = tile_ // tiles_w % tiles_h * th
            td0 = tile_ // (tiles_w * tiles_h) * td
            acc = np.zeros((8, mt_n, 16, np_))
            for c in range(cdiv(ci, 16)):
                c0 = 16 * c
                smem = np.full((slab_bytes + 64 * np_ * 32) // 2, np.nan)
                i = np.arange(2 * nvox)
                half, vox = i // nvox, i % nvox
                gw = tw0 - 1 + vox % sw
                gh = th0 - 1 + vox // sw % sh
                gd = td0 - 1 + vox // (sw * sh)
                ok = ((gd >= 0) & (gd < ds) & (gh >= 0) & (gh < hs)
                      & (gw >= 0) & (gw < ws))
                vals = np.zeros((len(i), 8))
                for j in range(8):
                    ch = c0 + 8 * half + j
                    take = ok & (ch < ci)
                    vals[take, j] = src[b, ch[take], gd[take], gh[take],
                                        gw[take]]
                store(smem, swz(vox, half), vals)
                i = np.arange(8 * np_ * 2)
                grp, n, half = i % 8, i // 8 % np_, i // (8 * np_)
                for e in range(8):
                    vals = np.zeros((len(i), 8))
                    for j in range(8):
                        ch = c0 + 8 * half + j
                        take = (ch < ci) & (n < co)
                        vals[take, j] = wflat[ch[take], n[take],
                                              8 * grp[take] + e]
                    store(smem, slab_bytes + swz((8 * grp + e) * np_ + n,
                                                 half), vals)
                for warp in range(8):
                    pd, ph, pw = warp >> 2, (warp >> 1) & 1, warp & 1
                    arow = (((m // th + 1 + pd) * sh + m % th + 1 + ph)[:, None]
                            * sw + A_ROW + 1 + pw)
                    for jd in range(2):
                        for jh in range(2):
                            for jw in range(2):
                                tap = (((2 * jd + 1 - pd) * 4 + 2 * jh + 1
                                        - ph) * 4 + 2 * jw + 1 - pw)
                                bm = b_tiles(smem, slab_bytes, tap * np_, nt)
                                back = (jd * sh + jh) * sw + jw
                                acc[warp] += a_tiles(
                                    smem, swz(arow - back, A_HALF)) @ bm
            # the skip tile and the 1x1x1 conv's weights
            smem = np.full((ck * voxels * 32 + 2 * ck * np_ * 32) // 2, np.nan)
            kt = 32 * 2 * th * 2 * td
            i = np.arange(2 * ck * kt)
            ww, hh = i % 32, i // 32 % (2 * th)
            dd, unit = i // (64 * th) % (2 * td), i // kt
            par = (dd & 1) * 4 + (hh & 1) * 2 + (ww & 1)
            row = (par * mt_n + (dd >> 1) * th + (hh >> 1)) * 16 + (ww >> 1)
            gd, gh, gw = 2 * td0 + dd, 2 * th0 + hh, 2 * tw0 + ww
            ok = (gd < d2) & (gh < h2) & (gw < w2)
            vals = np.zeros((len(i), 8))
            for j in range(8):
                ch = 8 * unit + j
                take = ok & (ch < co)
                vals[take, j] = skip[b, ch[take], gd[take], gh[take], gw[take]]
            store(smem, (unit >> 1) * voxels * 32 + swz(row, unit & 1), vals)
            base = ck * voxels * 32
            i = np.arange(4 * ck * np_)
            n, unit = i % np_, i // np_
            k, half = unit >> 1, unit & 1
            cc = np.where(k < ck, 16 * k, 16 * (k - ck)) + 8 * half
            off = np.where(k < ck, 0, co)
            vals = np.zeros((len(i), 8))
            for j in range(8):
                take = (n < co) & (cc + j < co)
                vals[take, j] = wc[n[take], off[take] + cc[take] + j]
            store(smem, base + swz(k * np_ + n, half), vals)
            for warp in range(8):
                pd, ph, pw = warp >> 2, (warp >> 1) & 1, warp & 1
                for mm in range(mt_n):
                    up = np.where(np.arange(np_) < co, acc[warp, mm], 0.0)
                    zs = np.zeros((16, np_))
                    for kk in range(ck):
                        a = np.zeros((16, 16))
                        a[:, :min(16, np_ - 16 * kk)] = up[:, 16 * kk:16 * kk
                                                           + 16]
                        zs += a @ b_tiles(smem, base, kk * np_, nt)
                    addr = swz((warp * mt_n + mm) * 16 + A_ROW, A_HALF)
                    for kk in range(ck):
                        zs += (a_tiles(smem, kk * voxels * 32 + addr)
                               @ b_tiles(smem, base, (ck + kk) * np_, nt))
                    d = 2 * (td0 + mm // th) + pd
                    h = 2 * (th0 + mm % th) + ph
                    w = 2 * (tw0 + np.arange(16)) + pw
                    if d < d2 and h < h2:
                        keep = w < w2
                        z[b, :, d, h, w[keep]] = zs[keep, :co]
    return z


@pytest.mark.parametrize("ci,co,src_dhw,skip_dhw,tile", [
    (20, 12, (2, 3, 11), (4, 5, 21), (1, 1)),
    (40, 24, (3, 3, 9), (5, 6, 17), (2, 2)),
    (16, 40, (2, 3, 4), (3, 5, 8), (2, 1)),
    (24, 16, (2, 3, 9), (3, 6, 17), (2, 1)),      # an odd width
])
def test_up_cat_tiling_matches_conv_transpose(ci, co, src_dhw, skip_dhw,
                                              tile):
    rng = np.random.default_rng(0)
    src = rng.standard_normal((1, ci, *src_dhw))
    skip = rng.standard_normal((1, co, *skip_dhw))
    wu = rng.standard_normal((ci, co, 4, 4, 4))
    wc = rng.standard_normal((co, 2 * co))
    got = up_cat_emulated(src, skip, wu, wc, tile)
    d2, h2, w2 = skip_dhw
    t = torch.from_numpy
    up = F.conv_transpose3d(t(src), t(wu), stride=2,
                            padding=1)[:, :, :d2, :h2, :w2]
    want = F.conv3d(torch.cat([up, t(skip)], dim=1),
                    t(wc)[:, :, None, None, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)


def store_w(smem, dst, vals, es, lo_off):
    """Weights staged as the source stages them: in the fp32 form
    (lo_off > 0) as two planes, high and low parts, here 3/4 and 1/4 of
    each value (so that both planes' addresses count)."""
    if lo_off:
        store(smem, dst, 0.75 * vals, es)
        store(smem, dst + lo_off, 0.25 * vals, es)
    else:
        store(smem, dst, vals, es)


def b_w(smem, base, row0, nt, es, lo_off):
    """``load_b``: the B fragments, in the fp32 form the high plane's plus
    the low plane's."""
    b = b_tiles(smem, base, row0, nt, es)
    return b + b_tiles(smem, base + lo_off, row0, nt, es) if lo_off else b


def stem_emulated(x, wd, wc, tile, form="bf16"):
    """stem_mma_kernel's sums on float64 values, its shifts, activations
    and roundings left out, but conv_down's map zeroed outside the
    StemBlock's output: conv(conv_down(x)), each 3x3 pad 1. ``form``:
    rows of 16 bf16 channels (the deploy form), or of 8 fp32 ones (the
    fp32 form, the conv's weights in passes through the window's
    region)."""
    b_, ci, h, w = x.shape
    c = wd.shape[-1]
    th, tw = tile
    kc, es, wb = (16, 2, 1) if form == "bf16" else (8, 4, 2)
    hv = kc // 2                   # values a 16-byte half
    ho, wo = h // 2, w // 2
    nt = cdiv(c, 8)
    np_, ck = 8 * nt, cdiv(c, kc)
    mw = tw + 2
    mp = (th + 2) * mw
    mt1, mt2 = cdiv(mp, 16), th * tw // 16
    image = ci == 3
    kd = 32 // kc if image else ci // kc
    sh_, se, sw_ = 2 * (th + 2) + 1, mw + 1, 2 * mw + 1
    wp = ck if form == "bf16" else stem_passes(ci, c, th, tw)
    tiles_w = cdiv(wo, tw)
    y = np.full((b_, c, ho, wo), np.nan)
    mt = np.arange(mt1)
    p_lane = np.minimum(mt[:, None] * 16 + A_ROW, mp - 1)
    for b in range(b_):
        for tile_ in range(tiles_w * cdiv(ho, th)):
            ox0, oy0 = tile_ % tiles_w * tw, tile_ // tiles_w * th
            iy0, ix0 = 2 * oy0 - 3, 2 * ox0 - 3
            acc1 = np.zeros((mt1, 16, np_))

            def window_value(ch, gy, gx):
                ok = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                out = np.zeros(len(gy))
                out[ok] = x[b, ch[ok] if np.ndim(ch) else ch, gy[ok], gx[ok]]
                return out

            if image:
                # one halo pixel a thread: k = 3 (3 kh + kw) + channel
                win = np.full(kd * mp * 32 // es, np.nan)
                p = np.arange(mp)
                my, mx = p // mw, p % mw
                vals = np.zeros((mp, 32))
                for kh in range(3):
                    for kw in range(3):
                        for ch in range(3):
                            vals[:, (kh * 3 + kw) * 3 + ch] = window_value(
                                ch, iy0 + 2 * my + kh, ix0 + 2 * mx + kw)
                for u in range(32 // hv):
                    store(win, (u >> 1) * mp * 32 + swz(p, u & 1),
                          vals[:, hv * u:hv * u + hv], es)
                wsh = np.full(wb * kd * np_ * 32 // es, np.nan)
                lo_off = (wb - 1) * kd * np_ * 32
                i = np.arange(kd * 2 * np_)
                n, u = i % np_, i // np_
                vals = np.zeros((len(i), hv))
                for j in range(hv):
                    k = hv * u + j
                    take = (n < c) & (k < 27)
                    tap = k[take] // 3
                    vals[take, j] = wd[k[take] % 3, tap // 3, tap % 3,
                                       n[take]]
                store_w(wsh, (u >> 1) * np_ * 32 + swz(n, u & 1), vals, es,
                        lo_off)
                for kc_ in range(kd):
                    acc1 += (a_tiles(win, kc_ * mp * 32 + swz(p_lane, A_HALF),
                                     es)
                             @ b_w(wsh, 0, kc_ * np_, nt, es, lo_off))
            else:
                arow = 2 * (p_lane // mw) * sw_ + p_lane % mw
                for c0 in range(0, ci, kc):
                    win = np.full(sh_ * sw_ * 32 // es, np.nan)
                    i = np.arange(2 * sh_ * sw_)
                    sx, sy, u = i % sw_, i // sw_ % sh_, i // (sw_ * sh_)
                    vals = np.stack([window_value(c0 + hv * u + j, iy0 + sy,
                                                  ix0 + sx)
                                     for j in range(hv)], axis=1)
                    store(win, swz(sy * sw_ + np.where(sx & 1, se, 0)
                                   + (sx >> 1), u), vals, es)
                    wsh = np.full(wb * 9 * np_ * 32 // es, np.nan)
                    lo_off = (wb - 1) * 9 * np_ * 32
                    i = np.arange(9 * np_ * 2)
                    n, tap, u = i % np_, i // np_ % 9, i // (9 * np_)
                    vals = np.zeros((len(i), hv))
                    for j in range(hv):
                        take = n < c
                        vals[take, j] = wd[(c0 + hv * u + j)[take],
                                           tap[take] // 3, tap[take] % 3,
                                           n[take]]
                    store_w(wsh, swz(tap * np_ + n, u), vals, es, lo_off)
                    for kh in range(3):
                        for kw in range(3):
                            toff = kh * sw_ + (se if kw == 1 else kw // 2)
                            acc1 += (a_tiles(win, swz(arow + toff, A_HALF),
                                             es)
                                     @ b_w(wsh, 0, (kh * 3 + kw) * np_, nt,
                                           es, lo_off))
            # the map: zero outside the output and past C
            mid = np.full(ck * mp * 32 // es, np.nan)
            p = np.arange(mp)
            gy, gx = oy0 - 1 + p // mw, ox0 - 1 + p % mw
            inside = (gy >= 0) & (gy < ho) & (gx >= 0) & (gx < wo)
            sums = acc1.reshape(-1, np_)[:mp]
            for half in range(2 * ck):
                ch = hv * half + np.arange(hv)
                vals = np.zeros((mp, hv))
                if hv * half < np_:
                    vals = np.where(inside[:, None] & (ch < c),
                                    sums[:, ch % np_], 0.0)
                store(mid, (half >> 1) * mp * 32 + swz(p, half & 1), vals, es)
            q = np.arange(mt2)[:, None] * 16 + A_ROW
            mrow = (q // tw) * mw + q % tw
            acc = np.zeros((mt2, 16, np_))
            for ck0 in range(0, ck, wp):
                n_ck = min(wp, ck - ck0)
                wsh = np.full(n_ck * wb * 9 * np_ * 32 // es, np.nan)
                lo_off = (wb - 1) * 9 * np_ * 32
                i = np.arange(n_ck * 9 * np_ * 2)
                n, tap, u = i % np_, i // np_ % 9, i // (9 * np_)
                cc = (ck0 + (u >> 1)) * kc + hv * (u & 1)
                vals = np.zeros((len(i), hv))
                for j in range(hv):
                    take = (n < c) & (cc + j < c)
                    vals[take, j] = wc[(cc + j)[take], tap[take] // 3,
                                       tap[take] % 3, n[take]]
                store_w(wsh, swz(((u >> 1) * wb * 9 + tap) * np_ + n, u & 1),
                        vals, es, lo_off)
                for k in range(n_ck):
                    for kh in range(3):
                        for kw in range(3):
                            acc += (a_tiles(mid, (ck0 + k) * mp * 32
                                            + swz(mrow + kh * mw + kw,
                                                  A_HALF), es)
                                    @ b_w(wsh, 0,
                                          (k * wb * 9 + kh * 3 + kw) * np_,
                                          nt, es, lo_off))
            # the output transpose [n][pixel], then 2 pixels a store (1
            # at an odd width)
            os_ = th * tw + 8
            out = np.full(np_ * os_, np.nan)
            qq = np.arange(th * tw)
            for n in range(c):
                out[n * os_ + qq] = acc.reshape(-1, np_)[qq, n]
            per = 2 if wo % 2 == 0 else 1
            e = np.arange(c * th * (tw // per))
            k, oy = e % (tw // per), e // (tw // per) % th
            n = e // (tw // per * th)
            gy, gx = oy0 + oy, ox0 + per * k
            keep = (gy < ho) & (gx < wo)
            for s in range(per):
                y[b, n[keep], gy[keep], gx[keep] + s] = out[
                    (n * os_ + oy * tw + per * k + s)[keep]]
    return y


@pytest.mark.parametrize("ci,c,shape,tile", [
    (3, 16, (1, 3, 20, 72), (8, 32)),
    (3, 32, (2, 3, 12, 36), (8, 16)),
    (16, 24, (1, 16, 20, 36), (8, 16)),
    (32, 48, (1, 32, 12, 68), (8, 32)),
    (16, 24, (2, 16, 10, 30), (8, 16)),     # stem_4 at an odd width
])
def test_stem_tiling_matches_conv2d(ci, c, shape, tile):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape)
    wd = rng.standard_normal((ci, 3, 3, c))
    wc = rng.standard_normal((c, 3, 3, c))
    got = stem_emulated(x, wd, wc, tile)
    t = torch.from_numpy
    mid = F.conv2d(t(x), t(wd).permute(3, 0, 1, 2), stride=2, padding=1)
    want = F.conv2d(mid, t(wc).permute(3, 0, 1, 2), padding=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)



# --- the fp32 form: 3xTF32 on m16n8k8 fragments -------------------------------

@pytest.mark.parametrize("ci,c", STEM_CASES)
def test_stem_plan_fp32(ci, c):
    """The fp32 form's plan: its instance, its shared memory counted region
    by region (the map in fp32 chunks of 8 channels; the conv's weights
    through the window's region, as many chunks a pass as it holds), and
    at least two blocks an SM."""
    plan = fs.stem_plan(ci, c, "fp32")
    th, tw = plan.tile
    assert plan.tile == fs.STEM_TILES[("fp32", ci, c)]
    assert ("fp32", ci, c, th, tw) in fs.STEM_INSTANCES
    assert plan.smem == stem_bytes(ci, c, th, tw, "fp32")
    assert 2 * (plan.smem + 1024) <= SM_SMEM
    assert tw % 16 == 0 and th * tw % 128 == 0
    assert stem_passes(ci, c, th, tw) >= 1
    with pytest.raises(ValueError, match="no instance"):
        fs.stem_plan(ci, c + 8, "fp32")


def stem_passes(ci, c, th, tw):
    """The fp32 form's conv-weight chunks a pass (WP in the source): each
    chunk its two TF32 planes."""
    np_, ck = 8 * cdiv(c, 8), cdiv(c, 8)
    region = stem_bytes(ci, c, th, tw, "fp32") - ck * (th + 2) * (tw + 2) * 32
    return min(ck, region // (2 * 9 * np_ * 32))


@pytest.mark.parametrize("ci,c,shape,tile", [
    (3, 16, (1, 3, 20, 72), (8, 32)),
    (3, 32, (2, 3, 12, 36), (8, 16)),
    (16, 24, (1, 16, 20, 36), (8, 16)),
    (32, 48, (1, 32, 12, 68), (8, 16)),
    (16, 24, (2, 16, 10, 30), (8, 32)),     # stem_4 at an odd width
])
def test_stem_tiling_fp32_matches_conv2d(ci, c, shape, tile):
    """The fp32 form's index math (rows of 8 fp32 channels, the image's 4
    chunks of 8 (tap, channel) values, m16n8k8 TF32 fragments through
    ldmatrix, the conv's weights in passes) against ``F.conv2d``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape)
    wd = rng.standard_normal((ci, 3, 3, c))
    wc = rng.standard_normal((c, 3, 3, c))
    got = stem_emulated(x, wd, wc, tile, "fp32")
    t = torch.from_numpy
    mid = F.conv2d(t(x), t(wd).permute(3, 0, 1, 2), stride=2, padding=1)
    want = F.conv2d(mid, t(wc).permute(3, 0, 1, 2), padding=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)


def tf32_rna(x):
    """cvt.rna.tf32.f32: fp32 to 10 explicit mantissa bits, to nearest,
    ties away from zero (the low 13 bits zero)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def dots_3xtf32(a, b, parts, passes=3):
    """The kernel's sums of a (n, K) . b (K,) in fp32: K in ``parts`` of 8
    (the order of the source's chunks and taps), each part the tensor
    core's products from zero (lo.hi, then hi.lo, then hi.hi, each m16n8k8
    rounded to fp32 as it accumulates), added to the running sum with one
    rounded add. ``passes`` 1: hi.hi alone (a one-pass TF32 product)."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    acc = np.zeros(len(a), np.float32)
    for idx in parts:
        terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
        part = np.zeros(len(a), np.float32)
        for u, v in terms:
            part = f32(part.astype(np.float64)
                       + u[:, idx].astype(np.float64) @ v[idx].astype(
                           np.float64))
        acc = f32(acc.astype(np.float64) + part)
    return acc


@pytest.mark.parametrize("ci", [3, 32, 48, 16, 24],
                         ids=["fan-in 27", "288", "432", "144", "216"])
def test_3xtf32_within_fp32_conditioning(ci):
    """Every StemBlock conv's fan-in (stem_2's conv_down 27; 288 for L's
    stem_2 conv and stem_4 conv_down, 432 its conv; S's 144, 216): the
    3xTF32 products and the kernel's order of sums (parts of 8 in (chunk,
    tap) order; stem_2's conv_down in (tap, channel) order, padded to 32)
    within 10 times the fp32 CPU conv's distance from float64, where a
    one-pass TF32 product lies further."""
    rng = np.random.default_rng(4)
    n_out = 16
    x = rng.standard_normal((1, ci, 24, 24)).astype(np.float32)
    w = (rng.standard_normal((n_out, ci, 3, 3))
         / np.sqrt(9 * ci)).astype(np.float32)
    t = torch.from_numpy
    want = F.conv2d(t(x).double(), t(w).double(), padding=1).numpy()
    cpu = F.conv2d(t(x), t(w), padding=1).double().numpy()
    cols = F.unfold(t(x), 3, padding=1)[0].numpy().T     # (L, ci * 9): (c, tap)
    if ci == 3:     # K = (tap, channel), zero-padded to 32, 4 parts of 8
        order = [c * 9 + tap for tap in range(9) for c in range(3)]
        parts = [np.arange(k, min(k + 8, 27)) for k in range(0, 27, 8)]
    else:           # K = (chunk of 8 channels, tap), a part a (chunk, tap)
        order = list(range(ci * 9))
        parts = [np.array([c * 9 + tap for c in range(c0, c0 + 8)])
                 for c0 in range(0, ci, 8) for tap in range(9)]
    a = cols[:, order]
    got, one = np.empty_like(cpu), np.empty_like(cpu)
    for o in range(n_out):
        wo = w[o].reshape(-1)[order]
        got[0, o] = dots_3xtf32(a, wo, parts).reshape(24, 24)
        one[0, o] = dots_3xtf32(a, wo, parts, passes=1).reshape(24, 24)
    cpu_err = np.abs(cpu - want).max()
    err = np.abs(got - want).max()
    assert err <= 10 * cpu_err
    assert np.abs(one - want).max() > 10 * cpu_err
