"""The launch plans and the tiling of kernel A (``csrc/fused_head.cu``,
``fused_head.stage0_plan``) and of kernel I (``csrc/fused_mixer.cu``,
``fused_mixer.mixer_plan``), on the CPU.

Each plan is held at the main paths' shapes and at ragged ones, in every
form: its tile and its cooperative grid, its shared memory
(recounted here region by region, against the card's limit) and its
workspace. The sources' layout constants and the C entry points' argument
lists are read from the sources and held against the Python mirrors. The
kernels' index math is written out below in numpy, line for line with the
source, on float64 values: A's tiles and vertical pixel pairs cover every
output pixel once, its image patch with each row's even columns first
feeds the stem the taps of ``F.conv2d``, and its pair dw is the 3x3
depthwise conv; I's tiles and lanes cover every (pixel, channel half)
once, its dw 7x7 over a column of the tile's rows is the 7x7 depthwise
conv, and its split MLP (two threads a pixel) is the ShuffleMixer MLP.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esmstereo_tpu_torch.nn.shufflemixer import channel_shuffle
from esmstereo_tpu_torch.ops.kernels import fused_head as fh
from esmstereo_tpu_torch.ops.kernels import fused_mixer as fm
from esmstereo_tpu_torch.ops.kernels.fused_hourglass import SMEM_MAX, SMS

CSRC = Path(__file__).resolve().parents[1] / "esmstereo_tpu_torch" / "csrc"
HEAD = (CSRC / "fused_head.cu").read_text()
MIXER = (CSRC / "fused_mixer.cu").read_text()
SM_SMEM = 233472          # an H100 SM's shared memory, 1 KB a block reserved


def cdiv(a, b):
    return -(-a // b)


def constant(src: str, name: str) -> int:
    """The value of ``constexpr int name = <int literal>`` in a source."""
    m = re.search(rf"\b{name} = (\d+)\s*[,;]", src)
    assert m, name
    return int(m.group(1))


# --- kernel A -------------------------------------------------------------

A_SHAPES = [(2, 544, 992), (2, 384, 1248), (1, 2, 2), (2, 34, 66),
            (1, 70, 130), (3, 2, 4), (4, 544, 992)]
A_CASES = [pytest.param(form, *shape, id=f"{form}-{shape}")
           for form in ("efficientnet_b2", "mobilenetv2_100")
           for shape in A_SHAPES]


def a_smem(form, batch):
    """Kernel A's dynamic shared memory, region by region: the staged
    weights, the image patch and 8 stem channels on the tile's 1-pixel
    halo (y0 on that halo fits in their place), efficientnet_b2's gates."""
    th, tw = 12, 32
    weights = 27 * 32 + 32 + 32 * 16 + 16 + 16 * 16 + 16
    patch = 3 * (2 * (th + 2) + 1) * (2 * (tw + 2) + 1)
    x0 = 8 * (th + 2) * (tw + 2)
    assert 16 * (th + 2) * (tw + 2) <= patch + x0
    gates = batch * (32 + 16) if form == "efficientnet_b2" else 0
    return 4 * (weights + patch + x0 + gates)


@pytest.mark.parametrize("form, batch, hi, wi", A_CASES)
def test_stage0_plan(form, batch, hi, wi):
    plan = fh.stage0_plan(form, batch, hi, wi)
    h, w = hi // 2, wi // 2
    tiles = batch * cdiv(h, 12) * cdiv(w, 32)
    assert (plan.tile, plan.threads) == ((12, 32), 192)
    if form == "mobilenetv2_100":
        assert (plan.grid, plan.workspace) == (tiles, 0)
    else:
        assert plan.grid == min(tiles, SMS * 3)
        assert plan.workspace == 4 + tiles * 48 + batch * 64 * h * w
    assert plan.smem == a_smem(form, batch) <= SMEM_MAX
    # three blocks an SM (the grid's residency) fit its shared memory
    assert 3 * (plan.smem + 1024) <= SM_SMEM + 1024


def test_stage0_plan_refuses():
    for args in (("efficientnet_b2", 1, 3, 4), ("efficientnet_b2", 1, 0, 4),
                 ("efficientnet_b2", 0, 4, 4), ("resnet", 1, 4, 4)):
        with pytest.raises(ValueError):
            fh.stage0_plan(*args)
    # the SE gates of every image sit in shared memory: a batch whose gates
    # pass the card's limit is refused, the largest one below it planned
    fit = (SMEM_MAX - a_smem("efficientnet_b2", 0)) // (4 * 48)
    fh.stage0_plan("efficientnet_b2", fit, 4, 4)
    with pytest.raises(ValueError):
        fh.stage0_plan("efficientnet_b2", fit + 1, 4, 4)


def test_stage0_source_layout():
    """The plan's constants are the source's."""
    assert re.search(r"kTh = 12, kTw = 32, kThreads = 192;", HEAD)
    assert constant(HEAD, "kChunk") == 8 == fh._CHUNK
    assert (fh.STAGE0_TILE, fh.STAGE0_THREADS) == ((12, 32), 192)
    assert re.search(r"__launch_bounds__\(kThreads, 3\)\s*stage0_coop", HEAD)
    assert re.search(r"__launch_bounds__\(kThreads, 3\)\s*stage0_single", HEAD)
    assert fh.STAGE0_BLOCKS_PER_SM == 3
    assert fh._WEIGHTS == 28 * 32 + 33 * 16 + 17 * 16


def c_params(src: str, fn: str) -> list:
    """The parameter types of ``extern "C" int fn(...)`` in a source."""
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
    assert m, fn
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


def ctype_of(c: str):
    if "*" in c or c == "cudaStream_t":
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[c]


@pytest.mark.parametrize("src, fn, argtypes", [
    (HEAD, "fused_stage0", fh.STAGE0_ARGTYPES),
    (MIXER, "fused_mixer", fm.MIXER_ARGTYPES)], ids=["A", "I"])
def test_entry_point_arguments(src, fn, argtypes):
    assert [ctype_of(c) for c in c_params(src, fn)] == list(argtypes)


def patch_col(q, pw):
    """csrc/fused_head.cu::patch_col: even columns, then the odd ones."""
    return (pw + 1) // 2 + (q >> 1) if q & 1 else q >> 1


@pytest.mark.parametrize("ny, nx", [(14, 34)])
def test_stage0_patch_columns(ny, nx):
    pw = 2 * nx + 1
    assert sorted(patch_col(q, pw) for q in range(pw)) == list(range(pw))
    # a warp's stem reads of one tap (lanes on consecutive x0 columns) fall
    # on consecutive words
    for kw in range(3):
        cols = [patch_col(2 * lx + kw, pw) for lx in range(32)]
        assert np.all(np.diff(cols) == 1)


@pytest.mark.parametrize("hi, wi", [(34, 66), (70, 130), (2, 4)])
def test_stage0_stem_replay(hi, wi):
    """load_patch + stem_chunk's index math on every tile of a ragged grid,
    against F.conv2d's stride-2 stem."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((3, hi, wi))
    w = rng.standard_normal((32, 3, 3, 3))
    ref = F.conv2d(torch.from_numpy(img)[None], torch.from_numpy(w),
                   stride=2, padding=1)[0].numpy()
    h, wd = hi // 2, wi // 2
    ny, nx = 14, 34
    ph, pw = 2 * ny + 1, 2 * nx + 1
    for ty in range(cdiv(h, 12)):
        for tx in range(cdiv(wd, 32)):
            gy0, gx0 = ty * 12 - 1, tx * 32 - 1
            patch = np.full(3 * ph * pw, np.nan)
            for i in range(3 * ph * pw):
                c, r, q = i // (ph * pw), (i // pw) % ph, i % pw
                iy, ix = 2 * gy0 - 1 + r, 2 * gx0 - 1 + q
                inside = 0 <= iy < hi and 0 <= ix < wi
                patch[(c * ph + r) * pw + patch_col(q, pw)] = (
                    img[c, iy, ix] if inside else 0.0)
            for i in range(ny * nx):
                gy, gx = gy0 + i // nx, gx0 + i % nx
                if not (0 <= gy < h and 0 <= gx < wd):
                    continue
                base = 2 * (i // nx) * pw + i % nx
                v = [patch[ci * ph * pw + kh * pw + patch_col(kw, pw) + base]
                     for ci in range(3) for kh in range(3) for kw in range(3)]
                np.testing.assert_allclose(w.reshape(32, 27) @ v,
                                           ref[:, gy, gx], atol=1e-12)


@pytest.mark.parametrize("hi, wi", [(34, 66), (2, 4), (544, 992)])
def test_stage0_pairs_cover(hi, wi):
    """Every output pixel is one tile pixel of one thread (rows 2w, 2w + 1
    of warp w, its lane's column), once."""
    h, w = hi // 2, wi // 2
    seen = np.zeros((h, w), int)
    tid = np.arange(192)
    for ty in range(cdiv(h, 12)):
        for tx in range(cdiv(w, 32)):
            for j in range(2):
                ly, lx = 2 * (tid // 32) + j, tid % 32
                gy, gx = ty * 12 + ly, tx * 32 + lx
                ok = (gy < h) & (gx < w)
                np.add.at(seen, (gy[ok], gx[ok]), 1)
    assert np.all(seen == 1)


def test_stage0_dw_pair_replay():
    """dw_act_pair's 4 rows, each read once for both pixels, in the taps'
    row-major order, against the 3x3 depthwise conv."""
    rng = np.random.default_rng(2)
    t = rng.standard_normal((2, 14, 34))
    wt = rng.standard_normal((2, 9))
    ref = F.conv2d(torch.from_numpy(t)[None], torch.from_numpy(wt).view(
        2, 1, 3, 3), groups=2)[0].numpy()
    for ly in range(1, 13, 2):
        for lx in range(1, 33):
            for c in range(2):
                s0 = s1 = 0.0
                for row in range(4):
                    v = t[c, ly - 1 + row, lx - 1:lx + 2]
                    for kw in range(3):
                        if row < 3:
                            s0 += wt[c, row * 3 + kw] * v[kw]
                        if row > 0:
                            s1 += wt[c, (row - 1) * 3 + kw] * v[kw]
                np.testing.assert_allclose(
                    [s0, s1], ref[c, ly - 1:ly + 1, lx - 1], atol=1e-12)


# --- kernel I -------------------------------------------------------------

I_SHAPES = [(1, 136, 248), (1, 4, 33), (2, 7, 45), (3, 13, 97), (1, 1, 1),
            (2, 136, 248), (8, 136, 248)]


def i_smem():
    """Kernel I's dynamic shared memory, region by region: the largest
    phase's staged weights (an expand phase: expand + bias, project +
    bias, up + bias), the data area up to the residual stream (the head's
    32-channel slab, the dw's 16-channel slab with a 3-pixel halo, the
    expand's slab and its SiLU map), then the stream."""
    th, tw, px = 3, 32, 96
    mlp = 16 + 8 * 16 + 16 + 16 * 8 + 8
    head = 32 * 9 * 16 + mlp
    dw = 16 * 52 + 16 + 2 * mlp
    expand = 16 * 9 * 32 + 32 + 32 * 16 + 16 + max(mlp, 16 * 64 + 64)
    data = max(32 * (th + 2) * (tw + 2), 16 * (th + 6) * (tw + 6),
               16 * (th + 2) * (tw + 2) + 32 * px, 16 * px + 8 * px)
    assert data <= fm._VS
    return 4 * (max(head, dw, expand) + fm._VS + 16 * px)


@pytest.mark.parametrize("batch, h, w", I_SHAPES,
                         ids=[str(s) for s in I_SHAPES])
def test_mixer_plan(batch, h, w):
    plan = fm.mixer_plan(batch, h, w)
    tiles = batch * cdiv(h, 3) * cdiv(w, 32)
    assert (plan.tile, plan.threads) == ((3, 32), 192)
    assert plan.grid == min(tiles, 3 * SMS)
    assert plan.smem == i_smem() and 3 * (plan.smem + 1024) <= SM_SMEM + 1024
    assert plan.workspace == 3 * batch * 16 * h * w + 4
    if (batch, h, w) == (1, 136, 248):
        # L's spx map: one tile a block, at most 3 blocks an SM
        assert plan.grid == tiles == 368 <= 3 * SMS


def test_mixer_plan_refuses():
    for args in ((0, 4, 4), (1, 0, 4), (1, 4, 0)):
        with pytest.raises(ValueError):
            fm.mixer_plan(*args)


def test_mixer_source_layout():
    assert constant(MIXER, "kTh") == 3 and constant(MIXER, "kTw") == 32
    assert "constexpr int kThreads = 2 * kPix;" in MIXER
    assert constant(MIXER, "kBlocksPerSm") == fm.MIXER_BLOCKS_PER_SM == 3
    assert constant(MIXER, "kVs") == fm._VS
    assert (fm.MIXER_TILE, fm.MIXER_THREADS) == ((3, 32), 192)
    assert fm._W_MAX == 16 * 9 * 32 + 32 + 32 * 16 + 16 + 16 * 64 + 64


@pytest.mark.parametrize("h, w", [(136, 248), (7, 45), (1, 1)])
def test_mixer_lanes_cover(h, w):
    """Each tile pixel has its two threads (channel halves), and the dw's
    (column, channel) tasks cover each channel column of the tile once."""
    seen = np.zeros((2, h, w), int)
    tid = np.arange(192)
    p, half = tid % 96, tid // 96
    for ty in range(cdiv(h, 3)):
        for tx in range(cdiv(w, 32)):
            gy, gx = ty * 3 + p // 32, tx * 32 + p % 32
            ok = (gy < h) & (gx < w)
            np.add.at(seen, (half[ok], gy[ok], gx[ok]), 1)
    assert np.all(seen == 1)
    tasks = [t for base in range(0, 512, 192) for t in base + tid if t < 512]
    assert sorted((t % 32, t // 32) for t in tasks) == sorted(
        (x, c) for x in range(32) for c in range(16))
    # a warp's tasks share their channel (its weights are one broadcast)
    for base in range(0, 512, 32):
        assert len({t // 32 for t in range(base, base + 32)}) == 1


def test_mixer_dw_column_replay():
    """dw_phase's column of the tile's 3 rows: each slab row read once for
    every output row it feeds, taps in row-major order, against the 7x7
    depthwise conv."""
    rng = np.random.default_rng(3)
    slab = rng.standard_normal((2, 9, 38))
    wt = rng.standard_normal((2, 49))
    ref = F.conv2d(torch.from_numpy(slab)[None], torch.from_numpy(wt).view(
        2, 1, 7, 7), groups=2)[0].numpy()
    for c in range(2):
        for lx in range(32):
            a = [0.0] * 3
            for row in range(9):
                v = slab[c, row, lx:lx + 7]
                for r in range(3):
                    kh = row - r
                    if 0 <= kh <= 6:
                        a[r] += float(wt[c, kh * 7:kh * 7 + 7] @ v)
            np.testing.assert_allclose(a, ref[c, :, lx], atol=1e-12)


def test_mixer_split_mlp_replay():
    """mlp_residual with two threads a pixel: half h computes fc1's outputs
    8h..8h+7 and fc2's 4h..4h+3, and adds to channel 8h + q the cat entry
    2q + h, against the ShuffleMixer MLP's shuffle."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal(16)
    norm = rng.standard_normal(16)
    fc1, b1 = rng.standard_normal((16, 8)), rng.standard_normal(16)
    fc2, b2 = rng.standard_normal((8, 16)), rng.standard_normal(8)
    n = (v - v.mean()) / np.sqrt(v.var() + 1e-5) * norm
    hid = np.zeros(16)
    ys = np.zeros(8)
    for half in range(2):
        a = b1[8 * half:8 * half + 8] + fc1[8 * half:8 * half + 8] @ n[:8]
        hid[8 * half:8 * half + 8] = a / (1 + np.exp(-a))
    for half in range(2):
        ys[4 * half:4 * half + 4] = (b2[4 * half:4 * half + 4]
                                     + fc2[4 * half:4 * half + 4] @ hid)
    out = v.copy()
    for half in range(2):
        for q in range(8):
            k = 2 * q
            cat = ys[k + half] if k < 8 else n[k + half]
            out[8 * half + q] = v[8 * half + q] + cat
    cat = torch.from_numpy(np.concatenate([ys, n[8:]]))[None, :, None, None]
    want = v + channel_shuffle(cat, 8)[0, :, 0, 0].numpy()
    np.testing.assert_allclose(out, want, atol=1e-12)
