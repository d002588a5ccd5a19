"""How the bf16 activations' rounding moves the port's L-deploy against the
JAX L-deploy, draw by draw, on the CPU (a diagnosis, not a test).

    JAX_PLATFORMS=cpu python tests/diag_torch_deploy_activations.py [SEED ...]

For each seed (default 0, the draw of tests/test_torch_deploy.py's
``deploy`` fixture) it builds that fixture's 64x128 pair and init-rule
weights from the seed, runs the JAX L-deploy (bf16, tanh GELU, compiled
with ``xla_allow_excess_precision=False``), the port's L in fp32 (the
deploy numerics' own error) and the port's L-deploy twice: as served
(torch's activations, one rounding) and per op
(``nn.blocks.set_bf16_per_op``, ``jax.nn``'s roundings). It prints, per
captured map, each run's max and mean distance from the JAX L-deploy and
its share of bit-exact values, the top-2 regression's flipped pixels
(init_pred off by more than half a bin) and the disparity's share of
pixels off by more than 1 px (tests/test_bf16.py's measure).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import test_torch_deploy as T  # noqa: E402
from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.nn import blocks as jblocks  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import state_dict_from_jax  # noqa: E402
from esmstereo_tpu_torch.models.esmstereo import ESMStereo  # noqa: E402
from esmstereo_tpu_torch.nn import blocks  # noqa: E402


def maps(disp, aux) -> dict:
    """A run's captured maps and disparity as fp32 numpy arrays."""
    def f32(v):
        return (v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
    return {**{k: f32(v) for k, v in aux.items()}, "disparity": f32(disp[0])}


def one_seed(seed: int) -> None:
    rng = np.random.default_rng(seed)
    left = rng.standard_normal((1, T.H, T.W, 3)).astype(np.float32)
    right = rng.standard_normal((1, T.H, T.W, 3)).astype(np.float32)
    port = ESMStereo(device="cpu", seed=seed)
    j16 = JaxESMStereo(JaxConfig(dtype=jnp.bfloat16))
    variables = T.jax_variables_from_port(port, jax.eval_shape(
        j16.init, jax.random.key(0), left, right))

    def run(v, l, r):
        jblocks.set_gelu_approximate(True)
        try:
            return j16.apply(v, l, r, capture_internals=True)
        finally:
            jblocks.set_gelu_approximate(False)

    jax_maps = maps(*jax.jit(run, compiler_options=T.LITERAL_BF16)(
        variables, left, right))
    with torch.inference_mode():
        fp32 = maps(*port(torch.from_numpy(left), torch.from_numpy(right),
                          capture_internals=True))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables), T.DEPLOY)
    runs = {}
    blocks.set_gelu_approximate(True)
    try:
        for name, per_op in (("served", False), ("per-op", True)):
            blocks.set_bf16_per_op(per_op)
            model = ESMStereo(T.DEPLOY, device="cpu")
            model.load_state_dict(sd)
            with torch.inference_mode():
                d, a = model(torch.from_numpy(left), torch.from_numpy(right),
                             capture_internals=True)
            runs[name] = maps(d, a)
    finally:
        blocks.set_bf16_per_op(False)
        blocks.set_gelu_approximate(False)
    print(f"== seed {seed}")
    for key in jax_maps:
        if key not in fp32:
            continue
        own = np.abs(jax_maps[key] - fp32[key])
        line = f"{key:11s} own max {own.max():.4g} mean {own.mean():.4g}"
        for name, r in runs.items():
            d = np.abs(r[key] - jax_maps[key])
            line += (f" | {name} max {d.max():.4g} mean {d.mean():.4g} "
                     f"exact {(d == 0).mean():.3f}")
            if key == "init_pred":
                line += f" flips {int((d > 0.5).sum())} of {d.size}"
        print(line)
    for name, r in (*runs.items(), ("fp32 (own)", fp32)):
        flips, sub = T._flips(r["disparity"], jax_maps["disparity"])
        print(f"disparity {name}: {flips:.4f} of pixels off by more than "
              f"1 px, mean {sub:.4f} over the others")


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    for seed in [int(a) for a in sys.argv[1:]] or [0]:
        one_seed(seed)


if __name__ == "__main__":
    main()
