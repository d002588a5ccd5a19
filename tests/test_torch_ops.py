"""PyTorch port: ops and blocks against their JAX functions (fp32, CPU).

Inputs come from ``np.random.default_rng``; each comparison states its
tolerance. JAX layouts (NHWC / NDHWC) are transposed to the port's NCHW /
NCDHW before comparing.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu import ops as jops  # noqa: E402
from esmstereo_tpu.nn import blocks as jblocks  # noqa: E402
from esmstereo_tpu.nn import shufflemixer as jsm  # noqa: E402
from esmstereo_tpu_torch.nn import blocks  # noqa: E402
from esmstereo_tpu_torch.nn import shufflemixer as tsm  # noqa: E402
from esmstereo_tpu_torch.ops import cost_volume, regression, sampling  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import activations  # noqa: E402

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = np.linspace(-8.0, 8.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=approximate))
    got = activations.gelu(torch.from_numpy(x), approximate).numpy()
    # fp32 transcendental implementations differ in the last bits
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_regression_topk_matches_jax(rng):
    cost = rng.standard_normal((2, 12, 8, 16)).astype(np.float32)
    want = np.asarray(jops.regression_topk(jnp.asarray(cost), None, 2))
    got = regression.regression_topk(torch.from_numpy(cost), 2)
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_disparity_regression_matches_jax(rng):
    cost = rng.standard_normal((2, 12, 8, 16)).astype(np.float32)
    want = np.asarray(jops.disparity_regression(jnp.asarray(cost), 12))
    got = regression.disparity_regression(torch.from_numpy(cost), 12)
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [(10, 14), (16, 32)])
def test_resize_bilinear_matches_jax(rng, size):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jops.resize_bilinear(jnp.asarray(x), size))
    got = sampling.resize_bilinear(_nchw(x), size)
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_resize_nearest_matches_jax(rng):
    x = rng.standard_normal((1, 5, 7, 2)).astype(np.float32)
    want = np.asarray(jops.sampling.resize_nearest(jnp.asarray(x), (11, 13)))
    got = sampling.resize_nearest(_nchw(x), (11, 13))
    np.testing.assert_array_equal(_to_nhwc(got), want)


def test_pixel_shuffle_matches_jax(rng):
    x = rng.standard_normal((2, 4, 6, 12)).astype(np.float32)
    want = np.asarray(jops.pixel_shuffle(jnp.asarray(x), 2))
    got = sampling.pixel_shuffle(_nchw(x), 2)
    np.testing.assert_array_equal(_to_nhwc(got), want)


def test_groupwise_correlation_matches_jax(rng):
    a = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    b = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    want = np.asarray(jops.groupwise_correlation(jnp.asarray(a),
                                                 jnp.asarray(b), 8))
    got = cost_volume.groupwise_correlation(_nchw(a), _nchw(b), 8)
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_channel_shuffle_matches_jax(rng):
    x = rng.standard_normal((1, 3, 5, 16)).astype(np.float32)
    want = np.asarray(jsm.channel_shuffle(jnp.asarray(x), 8))
    got = tsm.channel_shuffle(_nchw(x), 8)
    np.testing.assert_array_equal(_to_nhwc(got), want)


def test_channel_layer_norm_matches_jax(rng):
    x = rng.standard_normal((1, 3, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jsm.ChannelLayerNorm().apply(
        {"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x)))
    ln = tsm.ChannelLayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        got = ln(_nchw(x))
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims", [2, 3])
def test_conv_transpose_matches_jax_without_flip(rng, dims):
    """The bridge's deconv layout: JAX (*k, I, O) -> torch (I, O, *k)."""
    shape = (1,) + (3,) * dims + (5,)
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((4,) * dims + (5, 6)).astype(np.float32)
    want = np.asarray(jblocks.TorchConvTranspose(6, 4, 2, 1, dims=dims).apply(
        {"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x)))
    m = blocks.TorchConvTranspose(5, 6, 4, 2, 1, dims=dims)
    axes = (dims, dims + 1) + tuple(range(dims))
    perm_in = (0, dims + 1) + tuple(range(1, dims + 1))
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(k.transpose(axes)))
        got = m(torch.from_numpy(np.ascontiguousarray(x.transpose(perm_in))))
    perm_out = (0,) + tuple(range(2, dims + 2)) + (1,)
    np.testing.assert_allclose(got.numpy().transpose(perm_out), want,
                               rtol=1e-5, atol=1e-5)


def test_init_rules_scale(rng):
    """msra: std sqrt(2/(prod(k)*out)); torch: |w| <= 1/sqrt(fan_in)."""
    gen = torch.Generator().manual_seed(0)
    c = blocks.TorchConv(64, 128, 3, init_mode="msra")
    c.reset_parameters_from(gen)
    assert abs(float(c.weight.std()) - (2.0 / (9 * 128)) ** 0.5) < 2e-3
    t = blocks.TorchConv(64, 128, 3, use_bias=True)
    t.reset_parameters_from(gen)
    bound = 1.0 / (64 * 9) ** 0.5
    assert float(t.weight.abs().max()) <= bound
    assert float(t.bias.abs().max()) <= bound
    d = blocks.TorchConvTranspose(64, 32, 4)
    d.reset_parameters_from(gen)
    assert float(d.weight.abs().max()) <= 1.0 / (32 * 16) ** 0.5


def test_set_gelu_approximate_switches_apply_act():
    x = torch.linspace(-3, 3, 101)
    try:
        blocks.set_gelu_approximate(True)
        approx = blocks.apply_act(x, "gelu")
    finally:
        blocks.set_gelu_approximate(False)
    exact = blocks.apply_act(x, "gelu")
    assert torch.equal(approx, activations.gelu_tanh(x))
    assert torch.equal(exact, activations.gelu_exact(x))
