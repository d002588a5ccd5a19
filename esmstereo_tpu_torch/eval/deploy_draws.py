"""How ``chip_smoke.py`` [4]'s deploy criteria fall over independent
input draws.

    python3 -m esmstereo_tpu_torch.eval.deploy_draws [--draws 24] [PATH ...]
    python3 -m esmstereo_tpu_torch.eval.deploy_draws --ragged [--draws 24]

Run from the root of a checkout, on a CUDA device: it imports that
checkout's ``chip_smoke`` and runs its check of a deploy path against the
CPU (``check_deploy_against_cpu``: the card and the CPU in bf16 with tanh
GELU, beside the CPU in fp32, on 128x256 pairs) once per draw, each on a
generator seeded ``FIRST_SEED + draw``. PATH names deploy paths of
``chip_smoke`` (default: every one at cv8 and cv16). For each draw and map
it prints the card's mean distance from the CPU over the deploy numerics'
own (the CPU in bf16 against the CPU in fp32), pooled over the pairs the
check ran, the same ratio on each pair and of the maxima, and whether the
check passed; then per path and map the range of the pooled and of the
single-pair mean ratios and how many exceed 1, and the range of the
worst pair's max ratio. It reads the figures from
the lines the check prints for each pair, so it also runs in an earlier
checkout whose check prints the same lines (one pair per check there):
copy this file there and run it from that checkout's root, to hold two
trees to the same draws.

``--ragged`` runs ``chip_smoke``'s ragged check of the switches' deploy
forms (``check_ragged_switches_deploy``, at L's, M-norm's and S's widths)
once per draw instead, and prints, for kernels E, F, G, H and I, how the
share of outputs that differ by any bit falls over the draws for each
comparison (a step on its own input, or the whole chain against its plain
version): the largest and how many exceed E's, F's, G's and H's 1% (I's limit
is ``chip_smoke.MIXER_SHARE``); and how many draws failed the check, by
the kernel that failed (a draw stops at its first failure).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import re
import sys
import time

import torch

import chip_smoke
from esmstereo_tpu_torch.models.esmstereo import ESMStereo, ESMStereoConfig

LINE = re.compile(r"draw \d+ (\w+): card against CPU bf16 max (\S+) mean "
                  r"(\S+); CPU bf16 against CPU fp32 max (\S+) mean (\S+)")
# a ragged E, F, G, H or I comparison: its name, the part it holds (none for
# the whole level, as in earlier checkouts) and the share of outputs
# differing
RAGGED = re.compile(r"^  ((?:(?:volume_stem_agg|down_pair|up_pair|mixer) "
                    r"bf16|stems deploy) [^:\n]*): (?:([^:\n]*): )?max abs "
                    r"err .*; (\S+) of the outputs differ$", re.M)
FIRST_SEED = 1000


def deploy_paths() -> dict:
    """Every deploy path ``chip_smoke`` [4] holds against the CPU."""
    return {**chip_smoke.DEPLOY_PATHS, **chip_smoke.CPU_HELD_DEPLOY,
            **chip_smoke.SWITCHED_PATHS, **chip_smoke.CPU_HELD_SWITCHED}


def one_draw(name: str, config, seed: int) -> tuple[dict, str | None]:
    """``chip_smoke``'s check of path ``name`` on a generator seeded
    ``seed``: each map's (card max, card mean, own max, own mean) on each
    pair, as the check printed them, and its failure message, or None if
    it passed."""
    out, failure = io.StringIO(), None
    with contextlib.redirect_stdout(out):
        try:
            chip_smoke.check_deploy_against_cpu(
                torch.Generator().manual_seed(seed), config,
                confidence=name.startswith("C-"),
                ulp_slack=name not in chip_smoke.STRICT_DEPLOY)
        except RuntimeError as err:
            failure = str(err)
    maps = {}
    for key, *nums in LINE.findall(out.getvalue()):
        maps.setdefault(key, []).append(tuple(map(float, nums)))
    return maps, failure


def ragged(draws: int) -> int:
    """``--ragged``: E's, F's, G's, H's and I's shares of differing outputs per
    comparison over ``draws`` draws of the ragged check."""
    nets = [ESMStereo(ESMStereoConfig(**kw), device="cuda",
                      seed=chip_smoke.SEED)
            for kw in ({}, {"cv_scale": 8, "cost_volume": "norm_correlation"},
                       {"cv_scale": 16, "backbone": "mobilenetv2_100"})]
    shares, failed = {}, {}
    for draw in range(draws):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                chip_smoke.check_ragged_switches_deploy(
                    *nets, torch.Generator().manual_seed(FIRST_SEED + draw))
            except RuntimeError as err:
                kernel = str(err).removeprefix("chip_smoke: ").split()[0]
                failed[kernel] = failed.get(kernel, 0) + 1
                print(f"seed {FIRST_SEED + draw}: {err}", file=sys.stderr)
        for name, part, share in RAGGED.findall(out.getvalue()):
            # the comparison without its shape: kernel, form, level
            shares.setdefault((name.split(" (")[0], part or "the level"),
                              []).append(float(share))
    for (kernel, part), r in shares.items():
        print(f"SUMMARY ragged {kernel} {part}: {len(r)} comparisons, "
              f"largest share {max(r):.4%}, {sum(x > 0.01 for x in r)} above "
              f"1%")
    print(f"SUMMARY ragged: {sum(failed.values())} of {draws} draws failed "
          f"the check ({', '.join(f'{k} {n}' for k, n in failed.items())})")
    return 0


def spread(name: str, key: str, what: str, r: list) -> str:
    return (f"SUMMARY {name} {key}: {what} mean ratio {min(r):.4f}-"
            f"{max(r):.4f} over {len(r)}, {sum(x > 1 for x in r)} above 1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--draws", type=int, default=24)
    ap.add_argument("--ragged", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("deploy_draws: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.ragged:
        return ragged(args.draws)
    table = deploy_paths()
    names = args.paths or [n for n, c in table.items() if c.cv_scale != 4]
    print(f"card: {chip_smoke.smi_line()}; torch {torch.__version__}; "
          f"draws {args.draws} from seed {FIRST_SEED}")
    for name in names:
        t0 = time.perf_counter()
        pooled, single, tops, failed = {}, {}, {}, 0
        for draw in range(args.draws):
            seed = FIRST_SEED + draw
            maps, failure = one_draw(name, table[name], seed)
            failed += failure is not None
            for key, pairs in maps.items():
                cmax, cmean, omax, omean = zip(*pairs)
                card, own = sum(cmean) / len(pairs), sum(omean) / len(pairs)
                each = [c / o for c, o in zip(cmean, omean)]
                top = max(c / o for c, o in zip(cmax, omax))
                pooled.setdefault(key, []).append(card / own)
                single.setdefault(key, []).extend(each)
                tops.setdefault(key, []).append(top)
                print(f"{name} seed {seed} {key}: mean {card:.4e} / own "
                      f"{own:.4e} = {card / own:.4f} over {len(pairs)} "
                      f"pair(s) ({', '.join(f'{x:.4f}' for x in each)}); "
                      f"max at most {top:.4f} of the own")
            print(f"{name} seed {seed}: "
                  f"{'passed' if failure is None else failure}")
        for key in pooled:
            print(spread(name, key, "pooled", pooled[key]))
            print(spread(name, key, "single-pair", single[key]))
            print(f"SUMMARY {name} {key}: max ratio (the card's max "
                  f"distance over the own, worst pair of a draw) "
                  f"{min(tops[key]):.4f}-{max(tops[key]):.4f} over "
                  f"{len(tops[key])} draws")
        print(f"SUMMARY {name}: {failed} of {args.draws} draws failed the "
              f"check ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
