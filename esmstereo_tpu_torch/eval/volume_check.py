"""Kernel E against kernels B then C on the card: bit equality in every
form, and device time.

    python3 -m esmstereo_tpu_torch.eval.volume_check [--tile ROWS DEPTHS]

Run from the root of a checkout, on a CUDA device (the kernels build at
first use). For E's forms (fp32, bf16 descriptors, bf16 normalised) at G =
32 and G = 1, at L's and M's shapes of a 544 x 992 frame and at four ragged
ones, it prints whether ``fused_agg_stem.volume_stem_agg`` equals
``stem_agg(correlation_volume(...))`` bit for bit, with E's plan; then, at
the four rows of ``chip_smoke.py`` [3] (L gwc fp32 and bf16, M norm fp32
and bf16), the device time of E, of B + C, of B and of C alone (CUDA graphs
of 20 calls, ``eval/volume_rows.py``), twice. ``--tile`` gives E's conv
that (rows, depths) tile in place of its plan's, with the same chunks and
cluster split, in the bf16 forms (the sums do not depend on the tile):
every form must still equal B then C.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess

import torch

from esmstereo_tpu_torch.eval.volume_rows import graph_ms
from esmstereo_tpu_torch.ops.kernels import correlation, fused_agg_stem
from esmstereo_tpu_torch.ops.kernels import fused_hourglass

# (descriptor shape, bins, groups, normalised)
CASES = [((1, 64, 136, 248), 48, 32, False), ((1, 64, 68, 124), 24, 1, True),
         ((1, 64, 68, 124), 24, 32, False), ((2, 64, 7, 37), 13, 32, False),
         ((1, 64, 5, 19), 48, 1, True), ((2, 64, 7, 37), 13, 32, True),
         ((1, 64, 5, 19), 48, 1, False), ((1, 64, 9, 40), 7, 32, False)]
ROWS = [((1, 64, 136, 248), 48, 32, False, False),
        ((1, 64, 136, 248), 48, 32, False, True),
        ((1, 64, 68, 124), 24, 1, True, False),
        ((1, 64, 68, 124), 24, 1, True, True)]


@contextlib.contextmanager
def tile_override(tile):
    """E's bf16 forms on the MMA ``tile`` (rows, depths) with their plan's
    chunks and cluster split; nothing with ``tile`` None."""
    if tile is None:
        yield
        return
    plan, tiles = fused_agg_stem.conv_plan, fused_agg_stem.MMA_TILES

    def tiled(form, ci, co, d, h, w, stride):
        conv = plan(form, ci, co, d, h, w, stride)
        if form == "fp32":
            return conv
        return fused_hourglass.conv_layout(form, ci, co, d, h, w, stride,
                                           tile, conv.cluster)

    def clear():
        fused_agg_stem.volume_plan.cache_clear()
        fused_agg_stem._volume_ints.cache_clear()

    fused_agg_stem.conv_plan, fused_agg_stem.MMA_TILES = tiled, (tile,)
    clear()
    try:
        yield
    finally:
        fused_agg_stem.conv_plan, fused_agg_stem.MMA_TILES = plan, tiles
        clear()


def consts(gen, groups: int, low: bool) -> dict:
    """Random group_stem and agg weights with their BN: folded fp32, or
    raw bf16 with the fp32 scale and shift."""
    w1 = torch.randn((8, groups, 3, 3, 3), generator=gen) / (27 * groups) ** .5
    w2 = torch.randn((8, 8, 3, 3, 3), generator=gen) / 216 ** 0.5
    s1, s2 = (torch.rand(8, generator=gen) + 0.5 for _ in range(2))
    t1, t2 = (0.1 * torch.randn(8, generator=gen) for _ in range(2))
    if low:
        c = {"w1": w1.to(torch.bfloat16), "s1": s1, "t1": t1,
             "w2": w2.to(torch.bfloat16), "s2": s2, "t2": t2}
    else:
        view = (-1, 1, 1, 1, 1)
        c = {"w1": w1 * s1.view(view), "t1": t1, "w2": w2 * s2.view(view),
             "t2": t2}
    return {k: v.cuda().contiguous() for k, v in c.items()}


def calls(gen, shape, d, g, norm, low):
    """(E, B + C, B, C on B's volume) as callables on fresh inputs."""
    ref, tgt = (torch.randn(shape, generator=gen).cuda() for _ in range(2))
    if low:
        ref, tgt = ref.to(torch.bfloat16), tgt.to(torch.bfloat16)
    c = consts(gen, g, low)
    vol = correlation.correlation_volume(ref, tgt, d, g, normalize=norm)
    return (lambda: fused_agg_stem.volume_stem_agg(ref, tgt, c, d, g, True,
                                                   normalize=norm),
            lambda: fused_agg_stem.stem_agg(correlation.correlation_volume(
                ref, tgt, d, g, normalize=norm), c, True),
            lambda: correlation.correlation_volume(ref, tgt, d, g,
                                                   normalize=norm),
            lambda: fused_agg_stem.stem_agg(vol, c, True))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tile", type=int, nargs=2, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("volume_check: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; tile {args.tile or 'of the plan'}", flush=True)
    gen = torch.Generator().manual_seed(13)
    tile = tuple(args.tile) if args.tile else None
    with torch.inference_mode(), tile_override(tile):
        for shape, d, g, norm in CASES:
            for low in (False, True):
                e, bc, _, _ = calls(gen, shape, d, g, norm, low)
                desc = 4 if norm or not low else 2
                plan = fused_agg_stem.volume_plan(
                    "bf16" if low else "fp32", g, d, *shape[2:], desc).conv
                print(f"{shape} D={d} G={g}{' norm' if norm else ''} "
                      f"{'bf16' if low else 'fp32'}: tile {plan.tile}, "
                      f"cluster {plan.cluster}; equal to B then C "
                      f"{torch.equal(e(), bc())}", flush=True)
        for shape, d, g, norm, low in ROWS:
            fns = calls(gen, shape, d, g, norm, low)
            for _ in range(2):
                e, bc, b, c = (graph_ms(f) for f in fns)
                print(f"{shape} D={d} G={g} {'bf16' if low else 'fp32'}: "
                      f"device ms E {e:.4f}, B + C {bc:.4f} (B {b:.4f}, C "
                      f"{c:.4f})", flush=True)


if __name__ == "__main__":
    main()
