"""PyTorch port: the hourglass levels of the fused cost-volume section.

The plain versions of kernels G and H against the Pallas kernels they
replace, run in interpret mode on the CPU: G against
``fused_down_pair_apply`` at L's three down levels, H against
``fused_up_pair_apply`` at L's two up levels and a depth-crop case. The
CUDA kernels run only on the card (``chip_smoke.py`` holds each against its
plain version there); on CPU tensors the wrappers run their plain versions,
which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance. The
helpers are ``test_torch_fused_aggregation.py``'s.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu.attic import fused_hourglass as jfh  # noqa: E402
from esmstereo_tpu.nn.phasefold import interleave_indices  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_hourglass  # noqa: E402
from test_torch_fused_aggregation import (  # noqa: E402
    _block_tree, _fold, _jax_args, _port_block, _unfold)

torch.set_num_threads(2)


# --- kernel G: one hourglass down level ------------------------------------

@pytest.mark.parametrize("ci,co,d,h,w", [
    (8, 24, 48, 4, 8),        # L level 1
    (24, 40, 24, 4, 8),       # L level 2
    (40, 72, 12, 6, 4),       # L level 3, 3 output rows (odd)
])
def test_down_pair_plain_matches_pallas(rng, ci, co, d, h, w):
    """Against ``fused_down_pair_apply`` (interpret mode) with consts from
    its ``prepare_pair_consts``. Tolerance 1e-4, as
    tests/test_fused_hourglass.py."""
    trees = [_block_tree(rng, 3, ci, co), _block_tree(rng, 3, co, co)]
    x = rng.standard_normal((1, ci, d, h, w)).astype(np.float32)
    jconsts = jfh.prepare_pair_consts(*_jax_args(trees[0]),
                                      *_jax_args(trees[1]), depth=d,
                                      gelu_approximate=False)
    want = _unfold(jfh.fused_down_pair_apply(jnp.asarray(_fold(x)), jconsts,
                                             interpret=True), co)

    first = _port_block(trees[0], ci, co, 3, 2, 1)
    second = _port_block(trees[1], co, co, 3, 1, 1)
    with torch.no_grad():
        consts = fused_hourglass.prepare_down_consts(first, second)
        got = fused_hourglass.down_pair(torch.from_numpy(x), consts,
                                        False).numpy()
        blocks_out = second(first(torch.from_numpy(x))).numpy()
    assert got.shape == want.shape == (1, co, (d + 1) // 2, (h + 1) // 2,
                                       (w + 1) // 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the folded consts are the two ConvBlocks in eval mode
    np.testing.assert_allclose(got, blocks_out, rtol=1e-5, atol=1e-5)


# --- kernel H: one hourglass up level --------------------------------------

@pytest.mark.parametrize("ci_u,co,d_s,d2,hs,ws", [
    (72, 40, 6, 12, 3, 2),    # L level 3 -> 2
    (40, 24, 12, 24, 2, 4),   # L level 2 -> 1
    (16, 8, 2, 3, 2, 2),      # depth crop: 2 * d_s = 4 -> 3
])
def test_up_pair_plain_matches_pallas(rng, ci_u, co, d_s, d2, hs, ws):
    """Against ``fused_up_pair_apply`` (interpret mode) with consts from its
    ``prepare_up_consts``; skip at (d2, 2 hs, 2 ws). Tolerance 1e-4, as
    tests/test_fused_hourglass.py."""
    trees = [_block_tree(rng, 4, ci_u, co, deconv=True),
             _block_tree(rng, 1, 2 * co, co), _block_tree(rng, 3, co, co)]
    src = rng.standard_normal((1, ci_u, d_s, hs, ws)).astype(np.float32)
    skip = rng.standard_normal((1, co, d2, 2 * hs, 2 * ws)).astype(np.float32)
    jconsts = jfh.prepare_up_consts(
        *_jax_args(trees[0]), *_jax_args(trees[1]), *_jax_args(trees[2]),
        depth_in=d_s, depth_out=d2, in_perm=interleave_indices(d2, [co, co]),
        gelu_approximate=False)
    want = _unfold(jfh.fused_up_pair_apply(
        jnp.asarray(_fold(src)), jnp.asarray(_fold(skip)), jconsts,
        interpret=True), co)

    deconv = _port_block(trees[0], ci_u, co, 4, 2, 1, deconv=True)
    cat = _port_block(trees[1], 2 * co, co, 1, 1, 0)
    conv = _port_block(trees[2], co, co, 3, 1, 1)
    s, k = torch.from_numpy(src), torch.from_numpy(skip)
    with torch.no_grad():
        consts = fused_hourglass.prepare_up_consts(deconv, cat, conv)
        got = fused_hourglass.up_pair(s, k, consts, False).numpy()
        up = deconv(s)[:, :, :d2]
        blocks_out = conv(cat(torch.cat([up, k], dim=1))).numpy()
    assert got.shape == want.shape == skip.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, blocks_out, rtol=1e-5, atol=1e-5)
