"""The launch plan and the tiling of the hourglass conv3d k3 p1
(``csrc/fused_hourglass.cu``), on the CPU.

``conv_plan`` is held on every conv shape that kernels C, E's agg, G and H
launch at L, M and S on a 544 x 992 frame
(``models/esmstereo.py::conv3d_shapes``) in both forms, and the MMA
kernel's instances (``MMA_INSTANCES``, here and in the source) on exactly
the ones those convs need. Each CUDA kernel's
index math (tile origins, the stride-2 slab, the shared-memory swizzle,
the ldmatrix and mma fragment layouts, the zero-padded (chunk of 8 or 16
channels, tap) K order and the rank-ordered split-K sum) is written out
below in numpy, line for line with the source, and held against
``F.conv3d`` + BN + GELU at tiny shapes.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.models.esmstereo import ESMStereoConfig, conv3d_shapes
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import (
    FORMS, MAX_CLUSTER, MMA_INSTANCES, MMA_TILES, MMA_WARPS, SMEM_MAX, SMS,
    FP32_TILES, TUNED, conv_plan, conv_tiles)

SOURCE = (Path(__file__).resolve().parents[1] / "esmstereo_tpu_torch"
          / "csrc" / "fused_hourglass.cu")
CONFIGS = {"L": ESMStereoConfig(), "M": ESMStereoConfig(cv_scale=8),
           "M-norm": ESMStereoConfig(cv_scale=8,
                                     cost_volume="norm_correlation"),
           "S": ESMStereoConfig(cv_scale=16, backbone="mobilenetv2_100")}


def conv_shapes():
    """(label, ci, co, d, h, w, stride) of each distinct conv shape of L, M
    and S at 544 x 992, labelled by variant and conv ("L C group_stem", "M
    G2 s1"; M-norm's under M)."""
    out, seen = [], set()
    for var, config in CONFIGS.items():
        for name, *shape in conv3d_shapes(config, 544, 992):
            if tuple(shape) in seen:
                continue
            seen.add(tuple(shape))
            conv = name.split(".")[-1]
            label = (f"C {conv}" if conv in ("group_stem", "corr_stem", "agg")
                     else f"G{conv[4]} s{2 if conv.endswith('0') else 1}")
            out.append((f"{var.split('-')[0]} {label}", *shape))
    return out


def forms_of(ci, co, stride):
    forms = ["fp32", "bf16"]
    if stride == 1 and co % 8 == 0 and ci in (1, 32):
        forms += ["int8_bf16"]          # C's first conv on the int8 volume
    if stride == 1 and ci == 8 and co == 8:
        forms += ["bf16_fp32"]          # C's agg writing fp32 (int8 path)
    return forms


PLAN_CASES = [pytest.param(form, *shape[1:], id=f"{shape[0]} {form}")
              for shape in conv_shapes()
              for form in forms_of(*shape[1:3], shape[-1])]


@pytest.mark.parametrize("form,ci,co,d,h,w,stride", PLAN_CASES)
def test_conv_plan(form, ci, co, d, h, w, stride):
    plan = conv_plan(form, ci, co, d, h, w, stride)
    # the ranks cover each input channel exactly once, in order
    seen = [c for lo, hi in plan.ranks for c in range(lo, hi)]
    assert seen == list(range(ci))
    assert all(lo < hi for lo, hi in plan.ranks)
    assert 1 <= plan.cluster <= MAX_CLUSTER == 8
    assert len(plan.ranks) == plan.cluster
    assert plan.smem <= SMEM_MAX
    assert plan.groups * 8 * plan.co_blocks >= co
    # a wave of the card's SMs, or a tile smaller than the largest with
    # every split the channels allow (the fp32 kernel's in powers of two)
    largest = (FP32_TILES if form == "fp32" else MMA_TILES)[0]
    units = math.ceil(ci / plan.k_chunk)
    assert plan.k_chunk == (1 if form == "fp32" else
                            8 if ci <= 8 and plan.groups <= 3 else 16)
    assert plan.blocks >= SMS or (
        plan.tile[1:] != largest
        and 2 * plan.cluster > min(MAX_CLUSTER, units))
    if form == "fp32":
        assert plan.threads == 32 * plan.tile[1] * plan.groups <= 512
    else:
        assert plan.groups in FORMS[form][2]
        # the sums a consumer thread keeps: m-tiles x n-tiles x 4
        mt = plan.tile[1] * plan.tile[2] // MMA_WARPS
        assert 4 * mt * plan.groups <= 72


def test_conv_plan_refuses():
    with pytest.raises(ValueError):
        conv_plan("fp16", 8, 8, 4, 4, 4, 1)
    with pytest.raises(ValueError):
        conv_plan("fp32", 8, 8, 4, 4, 4, 3)
    # no model conv is 8 -> 8 at stride 2: the MMA kernel has no instance
    with pytest.raises(ValueError, match="no MMA instance"):
        conv_plan("bf16", 8, 8, 4, 4, 4, 2)


def test_mma_instances_are_what_the_model_convs_need():
    """Each deploy form's (stride, n-tiles, chunk) over the conv shapes of
    L, M and S, plus int8 -> fp32 where int8 -> bf16 runs (C's first
    convs, which the entry point takes in both output dtypes)."""
    needed = set()
    for _, ci, co, d, h, w, stride in conv_shapes():
        for form in forms_of(ci, co, stride)[1:]:
            plan = conv_plan(form, ci, co, d, h, w, stride)
            needed.add((form, stride, plan.groups, plan.k_chunk))
    needed |= {("int8_fp32", *k[1:]) for k in needed if k[0] == "int8_bf16"}
    assert needed == MMA_INSTANCES


def test_tuned_plans_are_model_convs():
    """Each ``TUNED`` entry is a conv shape of L, M or S in its form, with
    a tile and a split its kernel has, and ``conv_plan`` returns it."""
    shapes = {shape[1:] for shape in conv_shapes()}
    for (form, *shape), (tile, cluster) in TUNED.items():
        assert tuple(shape) in shapes
        ci, co, stride = shape[0], shape[1], shape[-1]
        assert tile in conv_tiles(form, ci, co, stride)
        plan = conv_plan(form, *shape)
        assert (plan.tile[1:], plan.cluster) == (tile, cluster)
        assert cluster <= min(MAX_CLUSTER, math.ceil(ci / plan.k_chunk))


def test_mma_instances_match_the_source():
    """``csrc/fused_hourglass.cu``'s ``MMA_INSTANCES`` X-list, by the
    forms' dtype codes, is ``fused_hourglass.MMA_INSTANCES``."""
    text = SOURCE.read_text()
    block = text[text.index("#define MMA_INSTANCES(X)"):]
    block = block[:block.index("\n\n")]
    by_codes = {v[:2]: k for k, v in FORMS.items()}
    listed = [(by_codes[(int(i), int(o))], int(s), int(nt), int(kc))
              for s, nt, kc, i, o in re.findall(
                  r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", block)]
    assert len(listed) == len(set(listed)) == len(MMA_INSTANCES)
    assert set(listed) == MMA_INSTANCES


# --- the kernels' index math, in numpy ---------------------------------------

def cdiv(a, b):
    return -(-a // b)


def swz(row, half):
    """csrc/fused_hourglass.cu::swz: byte offset of a 16-byte half."""
    return row * 32 + ((half ^ ((row >> 2) & 1)) << 4)


def wcol(stride, sw):
    if stride == 1:
        return sw
    return np.where(sw & 1, 17, 0) + (sw >> 1)


def ldmatrix(smem, addr, count):
    """``count`` 8x8 bf16 matrices from lane addresses ``addr`` (..., 32):
    lane 8 i + r gives row r of matrix i. Each row is 16-byte aligned and
    the 8 rows of a matrix fall in 8 distinct 16-byte bank groups (no bank
    conflict). Returns (..., count, 8, 8)."""
    rows = addr[..., :8 * count].reshape(*addr.shape[:-1], count, 8)
    assert (rows % 16 == 0).all()
    banks = np.sort(rows // 16 % 8, axis=-1)
    assert (banks == np.arange(8)).all()
    return smem[rows[..., None] // 2 + np.arange(8)]


def unit(kc, row, half):
    """csrc/fused_hourglass.cu::unit: byte offset of a 16-byte unit."""
    return swz(row, half) if kc == 16 else row * 16


def emulate_mma(x, w, scale, shift, stride, plan, approx):
    """conv3d_mma_kernel on float64 copies of bf16 values, in chunks of 16
    (m16n8k16) or 8 (m16n8k8) channels; returns y and checks each block's
    staging writes every byte of its slab and weights once."""
    b_, ci, d, h, wd = x.shape
    co = w.shape[0]
    s = stride
    _, th, td = plan.tile
    nt, r_, kc = plan.groups, plan.cluster, plan.k_chunk
    np_ = 8 * nt
    halves = kc // 8
    mt_n = th * td // MMA_WARPS
    do, ho, wo = ((n - 1) // s + 1 for n in (d, h, wd))
    sd, sh, sw = s * (td - 1) + 3, s * (th - 1) + 3, s * 15 + 3
    slab_bytes = sd * sh * sw * 2 * kc
    voxels = 16 * th * td
    ps = voxels + 4
    nch = cdiv(ci, kc)
    ncb = cdiv(co, np_)
    wflat = w.reshape(co, ci, 27)
    wrow = np_ + 1
    lane = np.arange(32)
    if kc == 16:
        a_row, a_half = (lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4
        b_n, b_half = (lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1
    else:
        a_row, a_half = lane & 15, 0
        b_n, b_half = lane & 15, 0
    nvox = sd * sh * sw
    y = np.zeros((b_, co, do, ho, wo))
    tiles_w, tiles_h = cdiv(wo, 16), cdiv(ho, th)
    tiles = tiles_w * tiles_h * cdiv(do, td)
    for b in range(b_):
        for cb in range(ncb):
            co0 = cb * np_
            for tile in range(tiles):
                wo0 = tile % tiles_w * 16
                ho0 = tile // tiles_w % tiles_h * th
                do0 = tile // (tiles_w * tiles_h) * td
                di0, hi0, wi0 = s * do0 - 1, s * ho0 - 1, s * wo0 - 1
                parts = []
                for rank in range(r_):
                    acc = np.zeros((MMA_WARPS, mt_n, nt, 16, 8))
                    for ch in range(rank * nch // r_, (rank + 1) * nch // r_):
                        smem = np.full((slab_bytes + 27 * wrow * 2 * kc) // 2,
                                       np.nan)
                        # stage_chunk's weight items (n, unit, tap): rows
                        # of np_ + 1 a tap, the last never written
                        k = np.arange(27 * halves * np_)
                        tap, half = k % 27, k // 27 % halves
                        n = k // (27 * halves)
                        dst = (slab_bytes + unit(kc, tap * wrow + n,
                                                 half)) // 2
                        for j in range(8):
                            c = kc * ch + 8 * half + j
                            val = np.where(
                                (co0 + n < co) & (c < ci),
                                wflat[np.minimum(co0 + n, co - 1),
                                      np.minimum(c, ci - 1), tap], 0.0)
                            assert np.isnan(smem[dst + j]).all()
                            smem[dst + j] = val
                        # stage_chunk's slab items (voxel, unit)
                        i = np.arange(halves * nvox)
                        half, vox = i // nvox, i % nvox
                        sw_, sh_ = vox % sw, vox // sw % sh
                        sd_ = vox // (sw * sh)
                        gd, gh, gw = di0 + sd_, hi0 + sh_, wi0 + sw_
                        dst = unit(kc, (sd_ * sh + sh_) * sw + wcol(s, sw_),
                                   half)
                        inside = ((gd >= 0) & (gd < d) & (gh >= 0) & (gh < h)
                                  & (gw >= 0) & (gw < wd))
                        for j in range(8):
                            c = kc * ch + 8 * half + j
                            val = np.where(
                                inside & (c < ci),
                                x[b, np.minimum(c, ci - 1),
                                  np.clip(gd, 0, d - 1), np.clip(gh, 0, h - 1),
                                  np.clip(gw, 0, wd - 1)], 0.0)
                            assert np.isnan(smem[dst // 2 + j]).all()
                            smem[dst // 2 + j] = val
                        # all written but the padding rows, which stay
                        # NaN: a read of one would poison the result
                        assert np.isnan(smem).sum() == 27 * kc
                        wsh = slab_bytes
                        # mma_chunk, the consumer warps' m-tiles at once
                        mg = np.arange(MMA_WARPS * mt_n)[:, None]
                        row0 = (s * (mg // th) * sh + s * (mg % th)) * sw \
                            + a_row
                        for kd in range(3):
                            for kh in range(3):
                                for kw in range(3):
                                    tap = (kd * 3 + kh) * 3 + kw
                                    bmat = []   # each n-tile's (8 n, kc)
                                    for j in range(0, nt - 1, 2):
                                        at = wsh + unit(kc, tap * wrow + j * 8
                                                        + b_n, b_half)
                                        if kc == 16:
                                            m = ldmatrix(smem, at, 4)
                                            bmat += [np.hstack(m[0:2]),
                                                     np.hstack(m[2:4])]
                                        else:
                                            bmat += list(ldmatrix(smem, at,
                                                                  2))
                                    if nt % 2:
                                        at = wsh + unit(kc, tap * wrow
                                                        + (nt - 1) * 8
                                                        + (lane & 7), b_half)
                                        m = ldmatrix(smem, at, halves)
                                        bmat.append(np.hstack(m))
                                    toff = ((kd * sh + kh) * sw
                                            + int(wcol(s, kw)))
                                    at = unit(kc, row0 + toff, a_half)
                                    m = ldmatrix(smem, at, 2 * halves)
                                    if kc == 16:
                                        a = np.concatenate(
                                            [np.concatenate([m[:, 0], m[:, 2]],
                                                            2),
                                             np.concatenate([m[:, 1], m[:, 3]],
                                                            2)], 1)
                                    else:
                                        a = np.concatenate([m[:, 0], m[:, 1]],
                                                           1)
                                    prod = np.einsum("mik,nkj->mnij", a,
                                                     np.stack(bmat).transpose(
                                                         0, 2, 1))
                                    acc += prod.reshape(MMA_WARPS, mt_n, nt,
                                                        16, 8)
                    # partial sums [n][voxel], through the C fragments
                    part = np.zeros(np_ * ps)
                    g, t = lane >> 2, lane & 3
                    for warp in range(MMA_WARPS):
                        for mt in range(mt_n):
                            m0 = (warp * mt_n + mt) * 16 + g
                            for n in range(nt):
                                for j in range(4):
                                    part[(n * 8 + 2 * t + (j & 1)) * ps + m0
                                         + 8 * (j >> 1)] = acc[
                                        warp, mt, n, g + 8 * (j >> 1),
                                        2 * t + (j & 1)]
                    parts.append(part)
                total = min(np_, co - co0) * voxels
                for rank in range(r_):
                    for base in range(rank * plan.threads, total,
                                      r_ * plan.threads):
                        e = np.arange(base, min(base + plan.threads, total))
                        n, m = e // voxels, e % voxels
                        pe = n * ps + m
                        acc_ = parts[0][pe].copy()
                        for q in range(1, r_):
                            acc_ += parts[q][pe]
                        ww, hh = wo0 + m % 16, ho0 + m // 16 % th
                        dd = do0 + m // (16 * th)
                        keep = (dd < do) & (hh < ho) & (ww < wo)
                        v = acc_ * scale[co0 + n] + shift[co0 + n]
                        y[b, (co0 + n)[keep], dd[keep], hh[keep],
                          ww[keep]] = v[keep]
    return gelu64(y, approx)


def gelu64(v, approx):
    return F.gelu(torch.from_numpy(v),
                  approximate="tanh" if approx else "none").numpy()


def emulate_fp32(x, w, shift, stride, plan, approx):
    """conv3d_fp32_kernel in float64: a thread (tx, ty, g)'s KDC x 8 sums
    over its rank's channels, then its own stores (R = 1) or the
    rank-ordered cluster sum."""
    b_, ci, d, h, wd = x.shape
    co = w.shape[0]
    s = stride
    _, th, kdc = plan.tile
    ng, r_ = plan.groups, plan.cluster
    np_ = 8 * ng
    do, ho, wo = ((n - 1) // s + 1 for n in (d, h, wd))
    sd, sh, sw = s * (kdc - 1) + 3, s * (th - 1) + 3, s * 31 + 3
    voxels = 32 * th * kdc
    nthr = 32 * th * ng
    tid = np.arange(nthr)
    tx, ty, g = tid & 31, (tid >> 5) % th, tid // (32 * th)
    y = np.full((b_, co, do, ho, wo), np.nan)
    tiles_w, tiles_h = cdiv(wo, 32), cdiv(ho, th)
    tiles = tiles_w * tiles_h * cdiv(do, kdc)
    wflat = w.reshape(co, ci, 27)
    for b in range(b_):
        for cb in range(cdiv(co, np_)):
            co0 = cb * np_
            for tile in range(tiles):
                wo0 = tile % tiles_w * 32
                ho0 = tile // tiles_w % tiles_h * th
                do0 = tile // (tiles_w * tiles_h) * kdc
                di0, hi0, wi0 = s * do0 - 1, s * ho0 - 1, s * wo0 - 1
                parts = []
                for rank in range(r_):
                    acc = np.zeros((nthr, kdc, 8))
                    for c in range(rank * ci // r_, (rank + 1) * ci // r_):
                        i = np.arange(sd * sh * sw)
                        sw_, sh_ = i % sw, i // sw % sh
                        sd_ = i // (sw * sh)
                        gd, gh, gw = di0 + sd_, hi0 + sh_, wi0 + sw_
                        ok = ((gd >= 0) & (gd < d) & (gh >= 0) & (gh < h)
                              & (gw >= 0) & (gw < wd))
                        xsh = np.where(ok, x[b, c, np.clip(gd, 0, d - 1),
                                             np.clip(gh, 0, h - 1),
                                             np.clip(gw, 0, wd - 1)], 0.0)
                        k = np.arange(27 * np_)
                        kk, o = k % 27, k // 27
                        wsh = np.zeros(27 * np_)
                        okw = co0 + o < co
                        wsh[kk * np_ + o] = np.where(
                            okw, wflat[np.minimum(co0 + o, co - 1), c, kk],
                            0.0)
                        for kh in range(3):
                            for kw in range(3):
                                col = xsh[(np.arange(sd) * sh + s * ty[:, None]
                                           + kh) * sw + s * tx[:, None] + kw]
                                for kd in range(3):
                                    wr = wsh[((kd * 3 + kh) * 3 + kw) * np_
                                             + 8 * g[:, None] + np.arange(8)]
                                    acc += (col[:, s * np.arange(kdc) + kd,
                                                None] * wr[:, None, :])
                    parts.append(acc)
                if r_ == 1:
                    for dd in range(min(kdc, do - do0)):
                        for o in range(8):
                            hh, ww = ho0 + ty, wo0 + tx
                            cc, dz = co0 + 8 * g + o, do0 + dd
                            keep = ((hh < ho) & (ww < wo) & (cc < co)
                                    & (dz < do))
                            y[b, cc[keep], dz, hh[keep], ww[keep]] = (
                                parts[0][keep, dd, o]
                                + shift[cc[keep]])
                    continue
                flat = []
                for acc in parts:
                    p = np.zeros(np_ * voxels)
                    for dd in range(kdc):
                        for o in range(8):
                            p[(8 * g + o) * voxels + (dd * th + ty) * 32
                              + tx] = acc[:, dd, o]
                    flat.append(p)
                total = min(np_, co - co0) * voxels
                e = np.arange(total)
                acc_ = flat[0][e].copy()
                for q in range(1, r_):
                    acc_ += flat[q][e]
                n, m = e // voxels, e % voxels
                ww, hh = wo0 + m % 32, ho0 + m // 32 % th
                dz = do0 + m // (32 * th)
                keep = (dz < do) & (hh < ho) & (ww < wo)
                y[b, (co0 + n)[keep], dz[keep], hh[keep], ww[keep]] = (
                    acc_[keep] + shift[co0 + n][keep])
    assert not np.isnan(y).any(), "an output no block stored"
    return gelu64(y, approx)


def reference(x, w, scale, shift, stride, approx):
    y = F.conv3d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                 padding=1).numpy()
    view = (1, -1, 1, 1, 1)
    return gelu64(y * scale.reshape(view) + shift.reshape(view), approx)


def bf16_values(rng, shape):
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return v.to(torch.bfloat16).double().numpy()


# (B, CI, D, H, W), CO, stride: S's ragged tails; a batch of 2; 40 input
# channels (3 chunks of 16) so that the MMA kernel splits them; 8 and 1
# input channels (its chunks of 8: agg, corr_stem, G's first level)
EMULATED = [((1, 12, 5, 9, 17), 12, 1), ((1, 12, 5, 9, 17), 24, 1),
            ((1, 12, 5, 9, 17), 12, 2), ((1, 12, 5, 9, 17), 24, 2),
            ((2, 40, 3, 5, 20), 16, 1), ((1, 40, 5, 9, 17), 12, 2),
            ((1, 8, 3, 5, 20), 8, 1), ((1, 1, 3, 5, 20), 8, 1),
            ((1, 8, 5, 9, 17), 24, 2)]


@pytest.mark.parametrize("shape,co,stride", EMULATED,
                         ids=[f"{s}-{c}-s{k}" for s, c, k in EMULATED])
def test_mma_tiling_matches_conv3d(shape, co, stride):
    rng = np.random.default_rng(10)
    x = bf16_values(rng, shape)
    w = bf16_values(rng, (co, shape[1], 3, 3, 3))
    scale = rng.uniform(0.5, 1.5, co)
    shift = rng.standard_normal(co)
    plan = conv_plan("bf16", shape[1], co, *shape[2:], stride)
    assert plan.k_chunk == (8 if shape[1] <= 8 else 16)
    if shape[1] > 16:
        assert plan.cluster > 1     # the rank-ordered split-K sum is run
    got = emulate_mma(x, w, scale, shift, stride, plan, True)
    want = reference(x, w, scale, shift, stride, True)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= 1e-5, err


@pytest.mark.parametrize("shape,co,stride", EMULATED,
                         ids=[f"{s}-{c}-s{k}" for s, c, k in EMULATED])
def test_fp32_tiling_matches_conv3d(shape, co, stride):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape)
    w = rng.standard_normal((co, shape[1], 3, 3, 3)) * 0.1
    shift = rng.standard_normal(co)
    plan = conv_plan("fp32", shape[1], co, *shape[2:], stride)
    # tiny grids split the channels they have
    assert plan.cluster > 1 or shape[1] == 1
    got = emulate_fp32(x, w, shift, stride, plan, False)
    want = reference(x, w, np.ones(co), shift, stride, False)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= 1e-5, err


def test_fp32_tiling_without_split():
    """A grid large enough for one block a tile (R = 1: each thread stores
    its own sums), at a width of 2 tiles and a masked channel group."""
    rng = np.random.default_rng(12)
    shape, co = (1, 1, 4, 66, 40), 12
    x = rng.standard_normal(shape)
    w = rng.standard_normal((co, 1, 3, 3, 3)) * 0.1
    shift = rng.standard_normal(co)
    plan = conv_plan("fp32", 1, co, *shape[2:], 1)
    assert plan.cluster == 1
    got = emulate_fp32(x, w, shift, 1, plan, True)
    want = reference(x, w, np.ones(co), shift, 1, True)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
