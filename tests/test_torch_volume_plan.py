"""Kernel E's launch plan and its slab producers (``csrc/fused_volume_agg.cu``),
on the CPU.

E runs kernel C's group_stem conv (``csrc/conv3d.cuh``) on a volume slab
that its producer builds from the descriptors, so ``volume_plan`` must be
C's group_stem plan for the same shape in its chunks and cluster split,
with the producer's shared memory counted. The producers' index math
(tile origins, the halo, the target's shifted window, zero where w < d
and outside the volume, the MMA slab's channel-innermost swizzled
``[d][h][w][KC]`` layout, the chunk and unit order, the cluster's group
split, the fp32 form's buffers) is written out below in numpy and held
against ``correlation_volume_plain`` at ragged tiny shapes: the bf16 gwc
and normalised slabs bit for bit, the fp32 form's gathered products bit
for bit (its 64-term sums at G = 1 within 4 fp32 ulps: the plain version
sums in torch's order). The entries are computed here with the plain
version's arithmetic on the gathered windows: what is tested is which
descriptor values reach which slab byte (the kernel's own sums are B's,
held bit for bit against kernels B then C on the card by
``chip_smoke.py``). Also the constants of ``csrc/activations_bf16.cu``
against the port's Python ones.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from esmstereo_tpu_torch.models.esmstereo import ESMStereoConfig, conv3d_shapes
from esmstereo_tpu_torch.ops.kernels import activations
from esmstereo_tpu_torch.ops.kernels.correlation import (
    correlation_volume_plain)
from esmstereo_tpu_torch.ops.kernels.fused_agg_stem import (
    FP32_BUILD, FP32_SUB, LOAD_WARPS, MMA_TILES, VOLUME_CHANNELS,
    volume_plan)
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import (
    MAX_CLUSTER, SMEM_MAX, SMS, conv_layout, conv_plan)

CSRC = Path(__file__).resolve().parents[1] / "esmstereo_tpu_torch" / "csrc"


def cdiv(a, b):
    return -(-a // b)


def unit(kc, row, half):
    """csrc/conv3d.cuh::unit (swz at 16 channels): a 16-byte unit's byte
    offset in the MMA slab."""
    if kc == 16:
        return row * 32 + ((half ^ ((row >> 2) & 1)) << 4)
    return row * 16


# --- the plan -----------------------------------------------------------------

# (config, frame) -> E's volume shapes: the served fused paths (L gwc, M
# norm, the full frame) and the ragged ones below
MODEL_CASES = [("L", ESMStereoConfig(fuse_volume_agg=True), 32),
               ("M-norm", ESMStereoConfig(cv_scale=8, fuse_volume_agg=True,
                                          cost_volume="norm_correlation"), 1),
               ("M", ESMStereoConfig(cv_scale=8, fuse_volume_agg=True), 32)]
RAGGED = [((2, 64, 7, 37), 13, 32, False), ((1, 64, 5, 19), 48, 1, True),
          ((2, 64, 7, 37), 13, 32, True), ((1, 64, 9, 40), 7, 32, False)]


def plan_cases():
    cases = []
    for name, config, g in MODEL_CASES:
        shapes = conv3d_shapes(config, 544, 992)
        stem = [s for s in shapes if s[0] in ("group_stem", "corr_stem")]
        assert len(stem) == 1, shapes
        _, ci, co, d, h, w, stride = stem[0]
        assert (ci, co, stride) == (g, 8, 1)
        cases += [pytest.param(form, g, d, h, w, id=f"{name} {form}")
                  for form in ("fp32", "bf16")]
    cases += [pytest.param(form, g, d, s[2], s[3], id=f"{s} D{d} G{g} {form}")
              for s, d, g, _ in RAGGED for form in ("fp32", "bf16")]
    return cases


@pytest.mark.parametrize("form,g,d,h,w", plan_cases())
def test_volume_plan(form, g, d, h, w):
    """E's plan is C's group_stem plan (``conv_plan(form, G, 8, D, H, W,
    1)``) in its chunks and cluster split, so the same sums in the same
    order; its tile is C's in fp32 and under a cluster split, else the
    largest MMA tile whose grid fills the card (each MMA row is one output
    voxel: a tile does not enter the sums). Its shared memory with the
    producer's buffers, counted here from the source's layout, fits the
    card's 227 KB; the cluster has at most 8 ranks, which cover each group
    exactly once."""
    desc_bytes = 4 if form == "fp32" or g == 1 else 2
    plan = volume_plan(form, g, d, h, w, desc_bytes)
    conv = conv_plan(form, g, 8, d, h, w, 1)
    assert (plan.conv.cluster, plan.conv.ranks, plan.conv.k_chunk,
            plan.conv.groups) == (conv.cluster, conv.ranks, conv.k_chunk,
                                  conv.groups)
    if form == "fp32" or conv.cluster > 1:
        assert plan.conv == conv
    else:
        assert plan.conv.blocks >= SMS
        assert plan.conv.tile[1:] == next(
            t for t in MMA_TILES if conv_layout(form, g, 8, d, h, w, 1, t,
                                                1).blocks >= SMS)
    conv = plan.conv
    _, th, td = conv.tile
    cpg = VOLUME_CHANNELS // g
    if form == "fp32":
        sd, sh, sw = td + 2, th + 2, 34
        slab = cdiv(sd * sh * sw, 4) * 4
        sub = min(cpg, FP32_SUB)
        desc = cdiv(sub * sh * sw + sub * sh * (sw + sd - 1), 4) * 4
        want = 4 * (cdiv(g, conv.cluster) * 27 * 8 + 2 * slab + 2 * desc)
        if conv.cluster > 1:
            want = max(want, 4 * 8 * 32 * th * td)
        assert plan.sub == sub and cpg % sub == 0
        # extra build threads only without a cluster split
        assert plan.threads == 32 * th * FP32_BUILD[g]
        assert FP32_BUILD[g] == 1 or conv.cluster == 1
    else:
        kc = conv.k_chunk
        assert kc == (16 if g == 32 else 8)
        sd, sh, sw = td + 2, th + 2, 18
        stage = 2 * kc * (sd * sh * sw + 27 * 9)
        nbuf = 2 if cdiv(cdiv(g, kc), conv.cluster) > 1 else 1
        chans = min(kc, g) * cpg
        desc = cdiv(chans * sh * (sw + sw + sd - 1) * desc_bytes, 16) * 16
        want = max(nbuf * stage + desc, 4 * 8 * (16 * th * td + 4))
        assert plan.load_warps == LOAD_WARPS[g]
        assert plan.threads == 32 * (4 + LOAD_WARPS[g])
    assert plan.smem == want <= SMEM_MAX
    assert 1 <= conv.cluster <= MAX_CLUSTER
    covered = [c for lo, hi in conv.ranks for c in range(lo, hi)]
    assert covered == list(range(g))


def test_volume_plan_refuses():
    """E takes G = 32 or 1 (C = 64)."""
    with pytest.raises(ValueError):
        volume_plan("bf16", 8, 12, 8, 16)


# --- the producers, in numpy --------------------------------------------------

def _descriptors(seed, shape, form):
    rng = np.random.default_rng(seed)
    ref, tgt = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for _ in range(2))
    if form == "fp32":
        return ref, tgt
    return ref.to(torch.bfloat16), tgt.to(torch.bfloat16)


def _entries(rv, tv, cpg, form):
    """Entries from gathered windows (..., channels, ...) with the plain
    version's arithmetic: rv, tv (ng kcpg, sd, sh, sw) fp32 -> (ng, sd, sh,
    sw) of the form's dtype."""
    ng = rv.shape[0] // cpg
    prod = rv * tv
    if form == "fp32":
        return prod.view(ng, cpg, *prod.shape[1:]).mean(dim=1)
    prod = prod.to(torch.bfloat16).float()
    s = prod.view(ng, cpg, *prod.shape[1:]).sum(dim=1)
    return (s * (1.0 / cpg)).to(torch.bfloat16)


def _maps(ref, tgt, g, normalize):
    """The maps the kernel reads: the descriptors in fp32, normalised as
    ``l2_normalize_groups`` writes them for the normalised forms."""
    r, t = ref.float(), tgt.float()
    if normalize:
        from esmstereo_tpu_torch.ops.cost_volume import l2_normalize_groups
        r, t = l2_normalize_groups(r, g), l2_normalize_groups(t, g)
    return r, t


def _windows(rb, tb, c0, nd, hi0, wi0, di0, sd, sh, sw):
    """BuildVolume::stage / copy_unit's descriptor staging: channels c0 ..
    c0 + nd of the reference over rows hi0 .., columns wi0 .. (sh x sw), of
    the target over the same rows and the shifted window of sw + sd - 1
    columns from wi0 - di0 - (sd - 1); zero outside the image. Then the
    entry (sd_, sh_, sw_) reads target column sw_ - sd_ + sd - 1."""
    h, w = rb.shape[1:]
    tgt_w = sw + sd - 1
    tw0 = wi0 - di0 - (sd - 1)
    rows = hi0 + np.arange(sh)
    rok = (rows >= 0) & (rows < h)

    def window(x, col0, ncol):
        cols = col0 + np.arange(ncol)
        ok = rok[:, None] & ((cols >= 0) & (cols < w))[None, :]
        v = x[c0:c0 + nd][:, torch.from_numpy(np.clip(rows, 0, h - 1))][
            :, :, torch.from_numpy(np.clip(cols, 0, w - 1))]
        return torch.where(torch.from_numpy(ok), v, torch.zeros(()))

    rd, td = window(rb, wi0, sw), window(tb, tw0, tgt_w)
    sdi = np.arange(sd)[:, None, None]
    swi = np.arange(sw)[None, None, :]
    rv = rd[:, None].expand(nd, sd, sh, sw)
    tcol = np.broadcast_to(swi - sdi + sd - 1, (sd, sh, sw))
    tv = td[:, torch.from_numpy(np.broadcast_to(
        np.arange(sh)[None, :, None], (sd, sh, sw)).copy()),
        torch.from_numpy(tcol.copy())]
    return rv, tv


def _inside(di0, hi0, wi0, sd, sh, sw, d, h, w):
    gd = di0 + np.arange(sd)[:, None, None]
    gh = hi0 + np.arange(sh)[None, :, None]
    gw = wi0 + np.arange(sw)[None, None, :]
    return torch.from_numpy((gd >= 0) & (gd < d) & (gh >= 0) & (gh < h)
                            & (gw >= 0) & (gw < w))


def _tiles(w, h, d, tw, th, td):
    tiles_w, tiles_h = cdiv(w, tw), cdiv(h, th)
    for tile in range(tiles_w * tiles_h * cdiv(d, td)):
        yield (tile // (tiles_w * tiles_h) * td, tile // tiles_w % tiles_h
               * th, tile % tiles_w * tw)


def _expected(vol, b, c0, ng, di0, hi0, wi0, sd, sh, sw):
    """The slab the consumer must see: the plain volume's entries of groups
    c0 .. c0 + ng at the slab's voxels, zero outside the volume."""
    _, _, d, h, w = vol.shape
    gd = np.clip(di0 + np.arange(sd), 0, d - 1)
    gh = np.clip(hi0 + np.arange(sh), 0, h - 1)
    gw = np.clip(wi0 + np.arange(sw), 0, w - 1)
    v = vol[b, c0:c0 + ng][:, torch.from_numpy(gd)][
        :, :, torch.from_numpy(gh)][:, :, :, torch.from_numpy(gw)]
    inside = _inside(di0, hi0, wi0, sd, sh, sw, d, h, w)
    return torch.where(inside, v, torch.zeros((), dtype=vol.dtype))


@pytest.mark.parametrize("shape,d,g,normalize", RAGGED,
                         ids=[f"{s} D{d} G{g}{' norm' if n else ''}"
                              for s, d, g, n in RAGGED])
def test_mma_producer_builds_the_volume(shape, d, g, normalize):
    """BuildVolume (the bf16 forms: form 1 on bf16 descriptors, form 2 on
    the fp32 normalised maps) over every block of the plan: the chunks of
    KC groups in order over each cluster rank's share, each slab's 16-byte
    units written once at ``unit(KC, voxel, half)``, zero outside the
    volume and past G; read back the way the consumer addresses the slab,
    each slab is the plain bf16 volume's entries bit for bit."""
    b_, c, h, w = shape
    cpg = c // g
    ref, tgt = _descriptors(7, shape, "bf16")
    vol = correlation_volume_plain(ref, tgt, d, g, normalize)
    rmap, tmap = _maps(ref, tgt, g, normalize)
    plan = volume_plan("bf16", g, d, h, w, 4 if normalize else 2)
    conv = plan.conv
    _, th, td = conv.tile
    kc, r_ = conv.k_chunk, conv.cluster
    sd, sh, sw = td + 2, th + 2, 18
    halves = kc // 8
    nvox = sd * sh * sw
    nch = cdiv(g, kc)
    seen = []
    for b in range(b_):
        for do0, ho0, wo0 in _tiles(w, h, d, 16, th, td):
            di0, hi0, wi0 = do0 - 1, ho0 - 1, wo0 - 1
            for rank in range(r_):
                for ch in range(rank * nch // r_, (rank + 1) * nch // r_):
                    c0 = kc * ch
                    ng = min(kc, g - c0)
                    seen += [(b, do0, ho0, wo0, c0 + j) for j in range(ng)]
                    rv, tv = _windows(rmap[b], tmap[b], c0 * cpg, ng * cpg,
                                      hi0, wi0, di0, sd, sh, sw)
                    ent = _entries(rv, tv, cpg, "bf16")
                    inside = _inside(di0, hi0, wi0, sd, sh, sw, d, h, w)
                    ent = torch.where(inside, ent,
                                      torch.zeros((), dtype=torch.bfloat16))
                    bits = ent.view(torch.int16).numpy().reshape(ng, nvox)
                    # the items (voxel, 8-group unit), each 8 2-byte cells
                    # from unit(kc, voxel, half), written once each
                    i = np.arange(halves * nvox)
                    half, vox = i // nvox, i % nvox
                    dst = unit(kc, vox, half) // 2
                    cells = (dst[:, None] + np.arange(8)).ravel()
                    assert len(np.unique(cells)) == cells.size == nvox * kc
                    slab = np.empty(nvox * kc, np.int64)
                    for j in range(8):
                        gl = 8 * half + j
                        slab[dst + j] = np.where(
                            gl < ng, bits[np.minimum(gl, ng - 1), vox], 0)
                    # the consumer's view: row vox, channel 8 half + j
                    got = np.empty((kc, nvox), np.int64)
                    for j in range(8):
                        got[8 * half + j, vox] = slab[dst + j]
                    want = _expected(vol, b, c0, ng, di0, hi0, wi0, sd, sh,
                                     sw).view(torch.int16).numpy()
                    np.testing.assert_array_equal(
                        got[:ng].reshape(ng, sd, sh, sw), want)
                    assert (got[ng:] == 0).all()
    # each (tile, group) once over the chunks and ranks
    assert len(seen) == len(set(seen)) == b_ * len(list(_tiles(
        w, h, d, 16, th, td))) * g


def _products(r, t, d):
    """The plain version's fp32 products ``r[c, h, w] * t[c, h, w - dd]``
    (zero where w < dd): (C, D, H, W)."""
    w = r.shape[-1]
    padded = torch.nn.functional.pad(t, (d - 1, 0))
    return torch.stack([r * padded[..., d - 1 - dd:d - 1 - dd + w]
                        for dd in range(d)], dim=1)


@pytest.mark.parametrize("shape,d,g,normalize", RAGGED,
                         ids=[f"{s} D{d} G{g}{' norm' if n else ''}"
                              for s, d, g, n in RAGGED])
def test_fp32_producer_builds_the_volume(shape, d, g, normalize):
    """volume_stem_fp32_kernel's pipeline over every block of the plan:
    the rank's groups in order, each in units of ``sub`` channels whose
    copies land in alternate descriptor buffers, the group's slab in
    alternate slab buffers, the FMAs of a group deferred to the next
    group's first unit (or the end), never on a buffer being written. Each
    unit's gathered products are the plain version's bit for bit at every
    slab voxel inside the volume; each slab the FMAs read is the plain fp32
    volume bit for bit where a group has 2 channels, and within 4 fp32
    ulps of its peak at G = 1 (the plain version's 64-term sum runs in
    torch's order, the kernel's in channel order, as kernel B's)."""
    b_, c, h, w = shape
    cpg = c // g
    ref, tgt = _descriptors(8, shape, "fp32")
    vol = correlation_volume_plain(ref, tgt, d, g, normalize)
    rmap, tmap = _maps(ref, tgt, g, normalize)
    plan = volume_plan("fp32", g, d, h, w)
    conv = plan.conv
    _, th, td = conv.tile
    sub, r_ = plan.sub, conv.cluster
    units_g = cpg // sub
    sd, sh, sw = td + 2, th + 2, 34
    for b in range(b_):
        prods = _products(rmap[b], tmap[b], d)
        for do0, ho0, wo0 in _tiles(w, h, d, 32, th, td):
            di0, hi0, wi0 = do0 - 1, ho0 - 1, wo0 - 1
            inside = _inside(di0, hi0, wi0, sd, sh, sw, d, h, w)
            gd = torch.from_numpy(np.clip(di0 + np.arange(sd), 0, d - 1))
            gh = torch.from_numpy(np.clip(hi0 + np.arange(sh), 0, h - 1))
            gw = torch.from_numpy(np.clip(wi0 + np.arange(sw), 0, w - 1))
            covered = []
            for rank in range(r_):
                c_begin, c_end = rank * g // r_, (rank + 1) * g // r_
                ng = c_end - c_begin
                desc = [None, None]
                slabs = [None, None]
                fmas = []

                def fma(gl):
                    got = slabs[gl & 1][1]
                    want = _expected(vol, b, c_begin + gl, 1, di0, hi0, wi0,
                                     sd, sh, sw)[0]
                    assert slabs[gl & 1][0] == gl
                    if cpg == 2:
                        assert torch.equal(got, want)
                    else:
                        peak = float(want.abs().max())
                        assert float((got - want).abs().max()) <= \
                            4 * peak * 2.0 ** -23
                    fmas.append(c_begin + gl)

                units = ng * units_g
                if units:
                    desc[0] = 0
                for u in range(units):
                    # wait + barrier: unit u's copies have landed
                    assert desc[u & 1] == u
                    if u + 1 < units:
                        desc[(u + 1) & 1] = u + 1
                    gl, s_ = u // units_g, u % units_g
                    cc = (c_begin + gl) * cpg + s_ * sub
                    rv, tv = _windows(rmap[b], tmap[b], cc, sub, hi0, wi0,
                                      di0, sd, sh, sw)
                    want = prods[cc:cc + sub][:, gd][:, :, gh][:, :, :, gw]
                    assert torch.equal(torch.where(inside, rv * tv, 0.0),
                                       torch.where(inside, want, 0.0))
                    if s_ == 0:
                        slabs[gl & 1] = [gl, [], None]
                    slabs[gl & 1][1].append((rv, tv))
                    if s_ == units_g - 1:
                        rvs = torch.cat([p[0] for p in slabs[gl & 1][1]])
                        tvs = torch.cat([p[1] for p in slabs[gl & 1][1]])
                        ent = _entries(rvs, tvs, cpg, "fp32")[0]
                        slabs[gl & 1][1] = torch.where(inside, ent,
                                                       torch.zeros(()))
                    if s_ == 0 and gl > 0:
                        assert (gl - 1) & 1 != gl & 1
                        fma(gl - 1)
                if ng:
                    fma(ng - 1)
                assert fmas == list(range(c_begin, c_end))
                covered += fmas
            assert covered == list(range(g))


# --- the bf16 activations' constants ------------------------------------------

def test_activation_constants_match_the_source():
    """``csrc/activations_bf16.cu``'s constants are the Python plain
    version's (``jax.nn``'s, rounded to bf16 as a weak-typed float meeting
    a bf16 array is), and its codes are ``ACTIVATIONS``'."""
    text = (CSRC / "activations_bf16.cu").read_text()
    got = {name: float(v) for name, v in re.findall(
        r"constexpr float (k\w+) = ([0-9.e-]+)f;", text)}
    assert got == {"kSqrt2OverPi": activations.SQRT_2_OVER_PI,
                   "kGeluCubic": activations.GELU_CUBIC,
                   "kSqrtHalf": activations.SQRT_HALF}
    for name, value in got.items():
        assert float(torch.tensor(value, dtype=torch.bfloat16)) == value
    codes = dict((int(c), n) for c, n in re.findall(
        r"(\d) (gelu_tanh|gelu_erf|silu|sigmoid|softmax)", text))
    assert codes == {v: k for k, v in activations.ACTIVATIONS.items()}
