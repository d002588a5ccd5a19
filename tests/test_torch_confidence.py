"""PyTorch port: the confidence model (ESMStereo-S plus the LAFNet head)
and the sampling ops it needs, against the JAX package.

``unfold3x3``, ``context_upsample``, ``grid_sample_bilinear`` and
``build_enlarged_grid`` against the jnp functions; ``ESMStereoConfidence``
with the norm-correlation volume (the published C row) against the JAX
model of the same config at 64x128, with seeded random values on its
``eval_shape`` tree (not ``init``: that zeroes ``scale_bn3``, and the
enlarged grid's scaling would go unseen); ESMStereo-S with the
norm-correlation volume against the same run's ``stereo`` submodule, the
JAX default S-norm model; the parameter counts of S-norm and of C in both
volumes; the bridge on the confidence tree; and the runner's two maps.

The head adds no kernel; its ESMStereo-S runs the S slice's kernels, whose
plain versions run on CPU tensors. Inputs come from
``np.random.default_rng``; each comparison states its tolerance.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu import ops as jops  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.models import confidence as jconf  # noqa: E402
from esmstereo_tpu_torch.data.io import normalize_image  # noqa: E402
from esmstereo_tpu_torch.eval.runner import (InferenceRunner,  # noqa: E402
                                             pad_to_next_multiple)
from esmstereo_tpu_torch.models.confidence import (  # noqa: E402
    ESMStereoConfidence, build_enlarged_grid)
from esmstereo_tpu_torch.models.convert_jax import state_dict_from_jax  # noqa: E402
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.ops import sampling  # noqa: E402
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

H, W = 64, 128
S = dict(cv_scale=16, backbone="mobilenetv2_100")
# parameters, from the JAX models' eval_shape: C (ACCURACY.json's C row)
# and S with the norm-correlation volume, C with gwc (the JAX class's
# default config)
PARAMS = {"C": 1_814_651, "S-norm": 1_722_450, "C-gwc": 1_865_187}
# XLA's CPU compile options for the JAX reference: skipping LLVM's
# expensive passes halves the compile and leaves the results' bits alone
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _rel(got, want) -> np.ndarray:
    want = np.asarray(want)
    return (np.abs(np.asarray(got) - want)
            / max(1.0, float(np.abs(want).max())))


# --- the sampling ops --------------------------------------------------------

def test_unfold_and_context_upsample_match_jax(rng):
    """``unfold3x3`` (zero padding, row-major taps) exactly, and
    ``context_upsample`` at x4 within 1e-6, against the jnp functions."""
    low = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    wts = rng.random((2, 20, 28, 9)).astype(np.float32)
    got = sampling.unfold3x3(_nchw(low)).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1),
                                  jops.unfold3x3(jnp.asarray(low)))
    got = sampling.context_upsample(_nchw(low), _nchw(wts), 4).numpy()
    want = jops.context_upsample(jnp.asarray(low), jnp.asarray(wts), 4)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_bilinear_matches_jax(rng, align_corners):
    """Sample points inside, on and beyond the borders (coordinates in
    [-1.6, 1.6], plus exact -1 and 1, where the zero padding takes part);
    within 1e-5 of the jnp function."""
    x = rng.standard_normal((2, 6, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (2, 5, 8, 2)).astype(np.float32)
    grid[:, 0, :4] = [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0]]
    got = sampling.grid_sample_bilinear(_nchw(x), torch.from_numpy(grid),
                                        align_corners).numpy()
    want = jops.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid),
                                     align_corners=align_corners)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-5,
                               atol=1e-5)
    assert (np.asarray(want) == 0).all(-1).any()   # some read only padding


def test_enlarged_grid_matches_jax(rng):
    """The asymmetric x/y offset scaling, within 1e-6."""
    scale = (2.0 * rng.random((2, 4, 6))).astype(np.float32)
    got = build_enlarged_grid(torch.from_numpy(scale)).numpy()
    want = jconf.build_enlarged_grid(jnp.asarray(scale))
    assert got.shape == (2, 12, 18, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --- the confidence model ----------------------------------------------------

@functools.cache
def _jax_c():
    """The JAX confidence model with the norm-correlation volume, seeded
    values on its ``eval_shape`` tree, and one input pair."""
    rng = np.random.default_rng(17)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    model = jconf.ESMStereoConfidence(JaxConfig(**S,
                                                cost_volume="norm_correlation"))
    small = np.zeros((1, 32, 64, 3), np.float32)
    variables = random_variables(
        jax.eval_shape(model.init, jax.random.key(0), small, small), rng)
    return model, variables, left, right


@functools.cache
def _jax_c_run():
    """The JAX C model (norm-correlation) on its pair, with the internals
    of its ``stereo`` submodule (S-norm's aux dict and disparity)."""
    model, variables, left, right = _jax_c()
    return jax.jit(lambda v, l, r: model.apply(v, l, r, capture_internals=True),
                   compiler_options=FAST_COMPILE)(variables, left, right)


def _count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("model", sorted(PARAMS))
def test_confidence_parameter_count(model):
    """The port's count against the JAX tree's: C's whole tree, S-norm's
    ``stereo`` subtree of it, and for C-gwc the port's S-gwc plus the JAX
    ``confidence_net`` subtree (the head does not depend on the volume)."""
    _, variables, _, _ = _jax_c()
    params = variables["params"]
    volume = "gwc" if model == "C-gwc" else "norm_correlation"
    config = ESMStereoConfig(**S, cost_volume=volume)
    if model == "S-norm":
        n_jax = _count(params["stereo"])
        port = ESMStereo(config, device="meta")
    else:
        n_jax = _count(params)
        port = ESMStereoConfidence(config, device="meta")
    if model == "C-gwc":
        n_jax = sum(p.numel() for p in port.stereo.parameters()) + _count(
            params["confidence_net"])
    n_port = sum(p.numel() for p in port.parameters())
    assert n_jax == n_port == PARAMS[model]


def test_confidence_matches_jax():
    """C (norm-correlation) at 64x128, fp32 on the CPU: the disparity and
    the confidence map on every pixel within 1e-4 relative (of max(1,
    max|JAX|)); cost, init_pred and match_left within 1e-4."""
    _, variables, left, right = _jax_c()
    (want_d, want_c), want_aux = _jax_c_run()

    config = ESMStereoConfig(**S, cost_volume="norm_correlation")
    port = ESMStereoConfidence(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, config))
    with torch.inference_mode():
        (disp, conf), aux = port(torch.from_numpy(left),
                                 torch.from_numpy(right),
                                 capture_internals=True)
    for key in ("cost", "init_pred", "match_left"):
        assert aux[key].shape == want_aux[key].shape, key
        assert _rel(aux[key], want_aux[key]).max() < 1e-4, key
    for got, want in ((disp, want_d), (conf, want_c)):
        assert got.shape == want.shape == (1, H, W)
        assert np.isfinite(got.numpy()).all()
        assert _rel(got, want).max() < 1e-4
    # the map is a confidence, and the seeded scale head moves the grid
    assert 0.0 < float(conf.min()) and float(conf.max()) < 1.0
    assert float(port.confidence_net.scale_bn3.weight.detach().abs().min()) \
        > 0.5


def test_s_norm_matches_jax():
    """ESMStereo-S with the norm-correlation volume, weights from the C
    tree's ``stereo`` subtree, against that JAX submodule (the JAX default
    S-norm model) in the same run, 64x128, fp32 on the CPU: match_left,
    f16, f4, cost, init_pred and disp_2 within 1e-4 relative (of max(1,
    max|JAX|)), the disparity on every pixel. The weights are seeded random
    values, so the attention map multiplies corr_stem's 8 channels, where
    it must, or the cost disagrees."""
    _, variables, left, right = _jax_c()
    (want_d, _), want_aux = _jax_c_run()
    config = ESMStereoConfig(**S, cost_volume="norm_correlation")
    stereo = {k: v["stereo"] for k, v in variables.items()}
    port = ESMStereo(config, device="cpu")
    port.load_state_dict(state_dict_from_jax(stereo, config))
    with torch.inference_mode():
        got, got_aux = port(torch.from_numpy(left), torch.from_numpy(right),
                            capture_internals=True)
    for key in ("match_left", "f16", "f4", "cost", "init_pred", "disp_2"):
        assert got_aux[key].shape == want_aux[key].shape, key
        assert _rel(got_aux[key], want_aux[key]).max() < 1e-4, key
    assert got[0].shape == want_d.shape == (1, H, W)
    assert _rel(got[0], want_d).max() < 1e-4
    assert not hasattr(port, "group_stem")
    assert len(port.semantic_1.weight) == 8         # corr_stem's channels


def test_confidence_bridge_and_runner():
    """The bridge holds the confidence tree against ``ESMStereoConfidence``
    and raises on an unmapped key; the runner crops both maps alike."""
    _, variables, _, _ = _jax_c()
    config = ESMStereoConfig(**S, cost_volume="norm_correlation")
    with pytest.raises(KeyError):                  # a gwc model's keys
        state_dict_from_jax(variables)
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["confidence_net"]["extra"] = {
        "Conv_0": {"bias": np.zeros(16, np.float32)}}
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_jax(extra, config)

    rng = np.random.default_rng(5)
    left = rng.integers(0, 256, (60, 100, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (60, 100, 3), dtype=np.uint8)
    model = ESMStereoConfidence(config, device="cpu", seed=3)
    (disp, conf), secs = InferenceRunner(model)(left, right)
    assert disp.shape == conf.shape == (60, 100) and secs > 0
    with torch.inference_mode():
        full = model(*(torch.from_numpy(pad_to_next_multiple(
            normalize_image(im))[None]) for im in (left, right)))
    np.testing.assert_array_equal(disp, full[0][0, 4:, 28:].numpy())
    np.testing.assert_array_equal(conf, full[1][0, 4:, 28:].numpy())
    with pytest.raises(ValueError):
        ESMStereoConfidence(ESMStereoConfig(cv_scale=8), device="meta")
