"""PyTorch port: ESMStereo-M (cv8) and the norm-correlation volume against
the JAX package.

The three forms of the correlation volume (gwc, gwc_norm,
norm-correlation) against the two Pallas kernels that build them, D
(``correlation_volume``, unfolded) and B (``correlation_volume_folded``),
in interpret mode; kernel E's normalised G = 1 form against
``folded_volume_stem_agg_apply``; then M-gwc, M-norm and L-norm, the JAX
default config of each variant, against the port with the same weights
through ``state_dict_from_jax(variables, config)``, and their parameter
counts.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each form
against its plain version there); on CPU tensors the wrappers run their
plain versions, which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from esmstereo_tpu import ops as jops  # noqa: E402
from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.ops.pallas import correlation as jcorr  # noqa: E402
from esmstereo_tpu.ops.pallas import fused_agg_stem as jfas  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import state_dict_from_jax  # noqa: E402
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.ops import cost_volume as tcv  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import correlation  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_agg_stem  # noqa: E402
from test_torch_fused_aggregation import (_block_tree, _jax_args,  # noqa: E402
                                          _port_block, _unfold)
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

H, W = 64, 128
# (cv_scale, cost_volume) -> parameters, from the JAX model's eval_shape;
# M gwc is ACCURACY.json's M row
PARAMS = {(8, "gwc"): 6_312_625, (8, "norm_correlation"): 6_305_929,
          (4, "norm_correlation"): 6_789_360}
VARIANTS = sorted(PARAMS, reverse=True)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _rel(got, want) -> np.ndarray:
    want = np.asarray(want)
    return (np.abs(np.asarray(got) - want)
            / max(1.0, float(np.abs(want).max())))


# --- the normalised correlations ---------------------------------------------

def test_normalised_correlations_match_jax(rng):
    """``groupwise_correlation_norm`` (8 groups) and ``norm_correlation``
    per plane against the jnp functions, within 1e-6; a zero pixel stays
    zero after normalisation."""
    a = rng.standard_normal((2, 5, 7, 64)).astype(np.float32)
    b = rng.standard_normal((2, 5, 7, 64)).astype(np.float32)
    b[:, 0, 0] = 0.0
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got = tcv.groupwise_correlation_norm(_nchw(a), _nchw(b), 8)
    want = jops.groupwise_correlation_norm(ja, jb, 8)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-6, atol=1e-6)
    got = tcv.norm_correlation(_nchw(a), _nchw(b))
    want = jops.norm_correlation(ja, jb)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-6, atol=1e-6)
    assert not got[:, :, 0, 0].any()


# --- kernels B and D: the three forms of the volume --------------------------

@pytest.mark.parametrize("groups,normalize",
                         [(32, False), (32, True), (1, True)],
                         ids=["gwc", "gwc_norm", "norm"])
def test_correlation_volume_forms_match_pallas(rng, groups, normalize):
    """Descriptors (1, 64, 4, 20), 8 bins: the plain version against D
    (``correlation_volume``, its (B, D, H, W, G) output with G moved
    ahead), against B (``correlation_volume_folded``, unfolded) and against
    the jnp builder, within 1e-5 relative to max(1, max|JAX|). Entries with
    w < d are exactly 0."""
    b, c, h, w, d = 1, 64, 4, 20, 8
    ref = rng.standard_normal((b, h, w, c)).astype(np.float32)
    tgt = rng.standard_normal((b, h, w, c)).astype(np.float32)
    got = correlation.correlation_volume(_nchw(ref), _nchw(tgt), d, groups,
                                         normalize=normalize).numpy()
    assert got.shape == (b, groups, d, h, w)

    jr, jt = jnp.asarray(ref), jnp.asarray(tgt)
    with pltpu.force_tpu_interpret_mode():
        unfolded = jcorr.correlation_volume(jr, jt, d, groups,
                                            normalize=normalize,
                                            interpret=True)
        folded = jcorr.correlation_volume_folded(jr, jt, d, groups,
                                                 normalize=normalize,
                                                 interpret=True)
    if not normalize:
        plain = jops.build_gwc_volume(jr, jt, d, groups)
    elif groups == 1:
        plain = jops.build_norm_correlation_volume(jr, jt, d)
    else:
        plain = jops.build_gwc_volume_norm(jr, jt, d, groups)
    wants = {
        "D": np.asarray(unfolded).transpose(0, 4, 1, 2, 3),
        "B": np.asarray(folded).reshape(b, h, w, d, groups).transpose(
            0, 4, 3, 1, 2),
        "jnp": np.asarray(plain).transpose(0, 4, 1, 2, 3)}
    for name, want in wants.items():
        assert _rel(got, want).max() < 1e-5, name
    for k in range(1, d):
        assert not got[:, :, k, :, :k].any()


# --- kernel E, normalised, G = 1 ---------------------------------------------

def test_volume_stem_agg_norm_plain_matches_pallas(rng):
    """corr_stem (1 -> 8) + agg on the norm-correlation volume built in
    kernel, 64 channels, 12 bins at 8 x 13 (an unaligned width), against
    ``folded_volume_stem_agg_apply(num_groups=1, normalize=True)`` in
    interpret mode. Tolerance 1e-4, as tests/test_fused_agg_stem.py."""
    c, d, h, w = 64, 12, 8, 13
    trees = [_block_tree(rng, 3, 1, 8), _block_tree(rng, 3, 8, 8)]
    ref = rng.standard_normal((1, h, w, c)).astype(np.float32)
    tgt = rng.standard_normal((1, h, w, c)).astype(np.float32)
    jconsts = jfas.prepare_consts(*_jax_args(trees[0]), *_jax_args(trees[1]),
                                  depth=d, gelu_approximate=False)
    want = _unfold(jfas.folded_volume_stem_agg_apply(
        jnp.asarray(ref), jnp.asarray(tgt), jconsts, num_groups=1,
        normalize=True, interpret=True), 8)

    stem = _port_block(trees[0], 1, 8, 3, 1, 1)
    agg = _port_block(trees[1], 8, 8, 3, 1, 1)
    with torch.no_grad():
        consts = fused_agg_stem.prepare_consts(stem, agg)
        got = fused_agg_stem.volume_stem_agg(_nchw(ref), _nchw(tgt), consts,
                                             d, 1, False,
                                             normalize=True).numpy()
    assert got.shape == want.shape == (1, 8, d, h, w)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --- the variants: the port against the JAX default config of each -----------

@functools.cache
def _jax_variant(cv_scale: int, cost_volume: str):
    """The JAX default-config model of the variant, its seeded variables
    (on its ``eval_shape`` tree) and one input pair. At cv4 ``conv1_up`` is
    scaled x30 as in test_torch_model.py, so that top-2 regression rarely
    meets a near-tie; cv8's regression is continuous and needs no margin."""
    rng = np.random.default_rng(cv_scale)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    model = JaxESMStereo(JaxConfig(cv_scale=cv_scale,
                                   cost_volume=cost_volume))
    # the variables' shapes do not depend on the input's; a 32x64 trace of
    # init is the cheaper one
    small = np.zeros((1, 32, 64, 3), np.float32)
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), small, small), rng)
    if cv_scale == 4:
        variables["params"]["aggregation_out"]["conv1_up"]["conv"][
            "kernel"] *= 30
    return model, variables, left, right


@pytest.mark.parametrize("cv_scale,cost_volume", VARIANTS)
def test_variant_parameter_count(cv_scale, cost_volume):
    _, variables, _, _ = _jax_variant(cv_scale, cost_volume)
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree.leaves(variables["params"]))
    config = ESMStereoConfig(cv_scale=cv_scale, cost_volume=cost_volume)
    n_port = sum(p.numel()
                 for p in ESMStereo(config, device="meta").parameters())
    assert n_jax == n_port == PARAMS[cv_scale, cost_volume]


@pytest.mark.parametrize("cv_scale,cost_volume", VARIANTS)
def test_variant_matches_jax(cv_scale, cost_volume):
    """64x128, fp32 on the CPU. match_left, f4 and cost within 1e-4
    relative (of max(1, max|JAX|)); disparity within 1e-4 relative on every
    pixel at cv8 (continuous regression of the raw cost), on at least 99%
    of pixels at cv4 (top-2 regression's knife-edge exemption, as
    test_torch_model.py); at cv8 also disp_2 (x2 of the /2 output) on every
    pixel."""
    model, variables, left, right = _jax_variant(cv_scale, cost_volume)
    want, want_aux = jax.jit(lambda v, l, r: model.apply(
        v, l, r, capture_internals=True))(variables, left, right)

    config = ESMStereoConfig(cv_scale=cv_scale, cost_volume=cost_volume)
    port = ESMStereo(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    with torch.inference_mode():
        got, got_aux = port(torch.from_numpy(left), torch.from_numpy(right),
                            capture_internals=True)

    for key in ("match_left", "f4", "cost"):
        assert got_aux[key].shape == want_aux[key].shape, key
        assert _rel(got_aux[key], want_aux[key]).max() < 1e-4, key
    disp = got[0].numpy()
    assert disp.shape == (1, H, W) and np.isfinite(disp).all()
    if cv_scale == 8:
        assert _rel(disp, want[0]).max() < 1e-4
        assert got_aux["disp_2"].shape == want_aux["disp_2"].shape
        assert _rel(got_aux["disp_2"], want_aux["disp_2"]).max() < 1e-4
    else:
        assert (_rel(disp, want[0]) < 1e-4).mean() >= 0.99


def test_bridge_checks_against_the_config():
    """The bridge holds a tree against the meta model of the config it is
    given: M's variables do not load as L's, nor gwc's as norm's."""
    _, variables, _, _ = _jax_variant(8, "gwc")
    with pytest.raises(KeyError):
        state_dict_from_jax(variables)
    with pytest.raises(KeyError):
        state_dict_from_jax(variables, ESMStereoConfig(
            cv_scale=8, cost_volume="norm_correlation"))
