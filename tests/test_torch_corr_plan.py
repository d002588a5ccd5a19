"""The launch plan and the index math of kernels B and D
(``csrc/correlation.cu::corr_volume_kernel``), on the CPU.

``corr_plan`` is held on every form of the volume (gwc, gwc_norm,
norm-correlation) at every served shape (L, M, S, C, and L at
``bench.py``'s unpadded 544 x 960): its block one of the source's shapes,
its shared memory the kernel's own count, within a block's default 48 KB.
The kernel's index math (the column tiles, each row's shifted onto
sectors, the window staged in shared memory, the normalised forms'
reference columns beside it, both normalised there in two phases, the
sums in channel order) is written out below in numpy, line for line with
the source, and
held against ``correlation_volume_plain`` at tiny ragged shapes: bit for
bit on the bf16 gwc form (B's rounding), within fp32 rounding elsewhere.
Shared memory starts as NaN, so a read of a word the kernel never staged
shows.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from esmstereo_tpu_torch.ops.kernels import correlation as corr

CSRC = Path(__file__).resolve().parents[1] / "esmstereo_tpu_torch" / "csrc"
# (name, (B, C, H, W), D) of each served descriptor pair
SERVED = [("L", (1, 64, 136, 248), 48), ("L 544x960", (1, 64, 136, 240), 48),
          ("M", (1, 64, 68, 124), 24), ("S", (1, 64, 34, 62), 12),
          ("C", (1, 64, 24, 78), 12)]
# (G, normalize) of the three forms
FORMS = {"gwc": (32, False), "gwc_norm": (32, True), "norm": (1, True)}
SMEM_DEFAULT = 48 * 1024


def cdiv(a, b):
    return -(-a // b)


def window_bytes(c, g, normalize, columns, shifts):
    """corr_volume_kernel's shared memory: C rows of columns + shifts - 1
    fp32 window columns; normalised, C rows of the block's reference
    columns, and G rows of the norms of both."""
    span = columns + shifts - 1
    return 4 * (c + g) * (span + columns) if normalize else 4 * c * span


@pytest.mark.parametrize("esize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name,shape,d", SERVED,
                         ids=[s[0] for s in SERVED])
def test_corr_plan_served(name, shape, d, form, esize):
    b, c, h, w = shape
    g, norm = FORMS[form]
    plan = corr.corr_plan(b, c, g, h, w, d, norm, esize)
    assert (plan.columns, plan.rows) in corr.BLOCKS
    assert plan == corr.make_plan(b, c, g, h, w, d, norm, plan.columns,
                                  plan.rows, esize)
    # a row of the volume not a whole number of 32-byte sectors takes one
    # more tile, the row's head (bf16 at every served W but 240; fp32 at
    # M's 124, S's 62 and C's 78)
    skewed = w % (32 // esize) != 0
    assert skewed == ((esize == 2 and w != 240) or w in (124, 62, 78))
    assert plan.grid == (cdiv(w, plan.columns) + skewed, h, b)
    assert plan.smem == window_bytes(c, g, norm, plan.columns, d) \
        <= SMEM_DEFAULT
    assert plan.ints() == (plan.columns, plan.rows, plan.smem)
    # 32 x 8 normalised; gwc 64 x 4 in fp32 at L, 32 x 8 where the grid
    # would not give every SM a block (S, C), else 32 x 4
    if norm:
        want = (32, 8)
    elif esize == 4 and name.startswith("L"):
        want = (64, 4)
    else:
        want = {"L": (32, 4), "L 544x960": (32, 4), "M": (32, 4),
                "S": (32, 8), "C": (32, 8)}[name]
    assert (plan.columns, plan.rows) == want


def test_corr_plan_refuses():
    with pytest.raises(NotImplementedError):
        corr.corr_plan(1, 64, 1, 4, 64, 8, False)    # G = 1 unnormalised
    with pytest.raises(NotImplementedError):
        corr.corr_plan(1, 64, 8, 4, 64, 8, False)    # G = 8
    # a window beyond the default 48 KB opts in, up to a block's most
    plan = corr.corr_plan(1, 64, 32, 4, 64, 80, True)
    assert SMEM_DEFAULT < plan.smem == window_bytes(64, 32, True, 32, 80) \
        <= corr.SMEM_MAX
    with pytest.raises(NotImplementedError):
        corr.corr_plan(1, 64, 32, 4, 64, 1000, True)


def test_instances_match_the_source():
    text = (CSRC / "correlation.cu").read_text()
    block = text[text.index("#define CORR_BLOCKS(X)"):]
    block = block[:block.index("\n\n")]
    found = [(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)",
                                                      block)]
    assert len(found) == len(set(found))
    assert set(found) == set(corr.BLOCKS)
    assert all(c * r <= 256 for c, r in found)
    # the entry point's C arguments: three pointers, eight ints, the plan
    # and the stream; the plan's three ints
    sig = text[text.index('extern "C" int correlation_volume('):]
    sig = sig[:sig.index(")")]
    assert sig.count("int ") == 9 and "const int* plan" in sig
    assert "TX = plan[0], rows = plan[1], smem = plan[2];" in text
    assert f"kSmemMax = {corr.SMEM_MAX};" in text


# --- the kernel's index math, in numpy ---------------------------------------

def fmaf(a, b, c):
    """fp32 a * b + c with one rounding (exact product in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


def corr_emulated(ref, tgt, d, g, normalize, rounding, plan, low):
    """corr_volume_kernel on fp32 values (bf16 descriptors widened):
    ``rounding`` each product rounded to bf16 (B's), else fmaf; ``low`` the
    volume rounded to bf16 at the store. Returns (B, G, D, H, W) fp32."""
    b_, c, h, w = ref.shape
    tx_n, rows = plan.columns, plan.rows
    cpg = c // g
    span = tx_n + d - 1
    eps = np.float32(1e-5)
    inv = np.float32(1.0) / np.float32(cpg)
    out = np.full((b_, g, d, h, w), np.nan, np.float32)
    tx = np.arange(tx_n)
    sector = 16 if low else 8          # values a 32-byte sector
    for bx in range(corr.column_tiles(w, tx_n, 2 if low else 4)):
        for hh in range(h):
            # row_skew: row hh's tiles start on its sector boundaries
            skew = 0 if w % sector == 0 else \
                tx_n - (sector - hh * w % sector) % sector
            for b in range(plan.grid[2]):
                w0 = bx * tx_n - skew
                tsh = np.full(c * span, np.nan, np.float32)
                x0 = w0 - (d - 1)
                i = np.arange(c * span)
                ws = x0 + i % span
                ok = (ws >= 0) & (ws < w)
                tsh[i[ok]] = tgt[b, (i // span)[ok], hh, ws[ok]]
                tsh[i[~ok]] = 0.0
                wcol = w0 + tx
                live = (wcol >= 0) & (wcol < w)
                r = np.zeros((c, tx_n), np.float32)      # r[c] of each thread
                r[:, live] = ref[b, :, hh, wcol[live]].T
                if normalize:
                    # the reference columns staged beside the window,
                    # normalised there the same way
                    rsh = r.reshape(-1).copy()
                    i = np.arange(g * tx_n)
                    base = i // tx_n * cpg * tx_n + i % tx_n
                    s = np.zeros(len(i), np.float32)
                    for k in range(cpg):
                        x = rsh[base + k * tx_n]
                        s = fmaf(x, x, s)
                    den = np.sqrt(s) + eps
                    i = np.arange(c * tx_n)
                    r = (rsh / den[i // (cpg * tx_n) * tx_n + i % tx_n]
                         ).reshape(c, tx_n)
                    # a thread a (group, column) sums its squares in channel
                    # order into den [G][span]; then every word is divided
                    i = np.arange(g * span)
                    base = i // span * cpg * span + i % span
                    s = np.zeros(len(i), np.float32)
                    for k in range(cpg):
                        x = tsh[base + k * span]
                        s = fmaf(x, x, s)
                    den = np.sqrt(s) + eps
                    i = np.arange(c * span)
                    tsh = tsh / den[i // (cpg * span) * span + i % span]
                lx = tx[live]
                for ty in range(rows):
                    for dd in range(ty, d, rows):
                        j = lx + (d - 1) - dd               # column w - d
                        for gg in range(g):
                            s = np.zeros(len(lx), np.float32)
                            for k in range(cpg):
                                ch = gg * cpg + k
                                x = tsh[ch * span + j]
                                if rounding:
                                    s = s + bf16(r[ch, lx] * x)
                                else:
                                    s = fmaf(r[ch, lx], x, s)
                            o = s * inv
                            out[b, gg, dd, hh, wcol[live]] = bf16(o) if low \
                                else o
    return out


RAGGED = [((2, 64, 3, 70), 13), ((1, 64, 2, 68), 11), ((1, 64, 2, 33), 7)]


@pytest.mark.parametrize("shape,d", RAGGED,
                         ids=[f"W{s[3]}-D{d}" for s, d in RAGGED])
def test_bf16_gwc_tiling_bit_for_bit(shape, d):
    """B's bf16 gwc form at ragged shapes (W not a multiple of a block's
    columns, D not of its rows), under the plan of each of the source's
    blocks (``corr_plan``'s among them): equal to the plain version bit for
    bit."""
    rng = np.random.default_rng(0)
    ref = bf16(rng.standard_normal(shape).astype(np.float32))
    tgt = bf16(rng.standard_normal(shape).astype(np.float32))
    want = corr.correlation_volume_plain(
        torch.from_numpy(ref).bfloat16(), torch.from_numpy(tgt).bfloat16(),
        d, 32, False, True).float().numpy()
    b, c, h, w = shape
    plans = [corr.make_plan(b, c, 32, h, w, d, False, *blk, 2)
             for blk in corr.BLOCKS]
    assert corr.corr_plan(b, c, 32, h, w, d, False, 2) in plans
    for plan in plans:
        got = corr_emulated(ref, tgt, d, 32, False, True, plan, True)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", list(FORMS))
def test_fp32_tiling_matches_plain(form):
    """The fp32 forms (the normalised ones normalising the window in
    shared memory and the reference columns in registers) at a ragged
    shape in 64-column blocks: within fp32 rounding of the plain
    version."""
    g, norm = FORMS[form]
    shape, d = (2, 64, 2, 70), 13
    rng = np.random.default_rng(1)
    ref = rng.standard_normal(shape).astype(np.float32)
    tgt = rng.standard_normal(shape).astype(np.float32)
    plan = corr.make_plan(2, 64, g, 2, 70, d, norm, 64, 4)
    got = corr_emulated(ref, tgt, d, g, norm, False, plan, False)
    want = corr.correlation_volume_plain(torch.from_numpy(ref),
                                         torch.from_numpy(tgt), d, g,
                                         norm).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale


def test_bf16_norm_tiling_matches_plain():
    """B's normalised bf16 form (G = 1): the kernel's normalisation in fp32
    runs in another order than the plain version's ``vector_norm``, so a
    rounded product may differ by an ulp; the entries within 2 bf16 ulps of
    max|plain| and nearly all bit-exact."""
    shape, d = (1, 64, 3, 70), 13
    rng = np.random.default_rng(2)
    ref = bf16(rng.standard_normal(shape).astype(np.float32))
    tgt = bf16(rng.standard_normal(shape).astype(np.float32))
    plan = corr.corr_plan(1, 64, 1, 3, 70, d, True, 2)
    got = corr_emulated(ref, tgt, d, 1, True, True, plan, True)
    want = corr.correlation_volume_plain(
        torch.from_numpy(ref).bfloat16(), torch.from_numpy(tgt).bfloat16(),
        d, 1, True, True).float().numpy()
    peak = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    assert np.abs(got - want).max() <= 2 * ulp
    assert (got == want).mean() >= 0.99
