"""PyTorch port: ESMStereo-S's backbone and the confidence model on S
with the norm-correlation volume (C, the published row) at the deploy
numerics (bf16 compute, tanh GELU) against the JAX package: kernel A's
mobilenetv2 form writing bf16 against ``fused_stage0_apply`` in interpret
mode; C-deploy's cost and disparity (its ``stereo`` submodule is
S-norm-deploy) and its confidence map against the JAX bf16 model of the
same config; the parameter counts of C-deploy and S-norm-deploy against
the JAX ``eval_shape``.

B's normalised bf16 form is held in tests/test_torch_deploy_variants.py,
whose helpers this file shares; on CPU tensors the wrappers run their
plain versions. Inputs come from ``np.random.default_rng``; each
comparison states its tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from esmstereo_tpu.backbones.fused import FusedHeadPyramid  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.models import confidence as jconf  # noqa: E402
from esmstereo_tpu.ops import pallas as jpallas  # noqa: E402
from esmstereo_tpu_torch.backbones import fused as fused_backbone  # noqa: E402
from esmstereo_tpu_torch.backbones.efficientnet import FeaturePyramid  # noqa: E402
from esmstereo_tpu_torch.models.confidence import ESMStereoConfidence  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import (  # noqa: E402
    convert_tree, state_dict_from_jax)
from esmstereo_tpu_torch.models.esmstereo import ESMStereoConfig  # noqa: E402
from esmstereo_tpu_torch.nn import blocks  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_head  # noqa: E402
from test_torch_deploy import _ulp, jax_variables_from_port  # noqa: E402
from test_torch_deploy_variants import (SERVED, SERVED_TIMES,  # noqa: E402
                                        _deploy, _jax_shapes, _no_further,
                                        _rng_pair, _run_fp32, _run_jax,
                                        _run_port,
                                        check_parameter_count)
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)


# --- kernel A's mobilenetv2 form writing bf16 --------------------------------

def test_fused_head_mobilenetv2_bf16_out_matches_pallas(rng):
    """mobilenetv2_100's pyramid at 32 x 64 with seeded variables, against
    ``FusedHeadPyramid(arch="mobilenetv2_100", dtype=bfloat16)`` with its
    head run as ``fused_stage0_apply`` in interpret mode: every level is
    bf16, and kernel A's bf16 output (the pyramid's first level) is within
    1 bf16 ulp of max(1, max|JAX|) of the interpret-mode kernel's fp32
    output cast to bf16 (the fp32 heads differ by ~1e-7, which can move a
    rounding by one ulp)."""
    img = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    jp = FusedHeadPyramid(arch="mobilenetv2_100", dtype=jnp.bfloat16)
    v = random_variables(jax.eval_shape(
        lambda x: jp.init(jax.random.key(0), x, train=False), img), rng)
    jpallas.set_force_interpret(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jax.jit(lambda v, x: jp.apply(v, x, train=False))(
                v, jnp.asarray(img))
    finally:
        jpallas.set_force_interpret(False)
    pyr = FeaturePyramid("mobilenetv2_100", device="cpu").eval()
    pyr.load_state_dict(convert_tree(v))
    blocks.set_compute_dtype(pyr, torch.bfloat16)
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        feats = pyr(x)
        consts = fused_backbone.prepare_consts(pyr)
        head = fused_head.fused_stage0(x, consts, torch.bfloat16)
    assert fused_head.kernel_form(consts) == "mobilenetv2_100"
    assert torch.equal(head, feats[0])
    assert len(feats) == len(want) == 5
    for g, w in zip(feats, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert g.shape == np.asarray(w).transpose(0, 3, 1, 2).shape
    w0 = np.asarray(want[0].astype(jnp.float32)).transpose(0, 3, 1, 2)
    err = float(np.abs(head.float().numpy() - w0).max())
    assert err <= _ulp(max(1.0, float(np.abs(w0).max()))), err


def test_confidence_deploy_parameter_counts():
    """C-deploy against the JAX confidence model's tree, and S-norm-deploy
    against that tree's ``stereo`` subtree (the JAX S-norm model's), by
    ``check_parameter_count``."""
    shapes = _jax_shapes("C-deploy")
    check_parameter_count("C-deploy", shapes)
    check_parameter_count("S-norm-deploy",
                          {k: v["stereo"] for k, v in shapes.items()})


@pytest.fixture(scope="module")
def c_deploy():
    """One 96x160 pair through the JAX confidence model on S-norm in bf16,
    the port's in fp32 (``_run_fp32``) and the port's C-deploy, on
    init-rule weights
    drawn by the port (seed 0; ``scale_bn3``, zero at init, gets scales in
    [0.75, 1.25) so that the enlarged grid's scaling is seen), carried to
    JAX by the bridge run backwards. Returns ``{name: {"cost",
    "disparity", "confidence"}}`` as numpy fp32, and the dtypes of the
    port's and JAX's bf16 confidence maps."""
    left, right = _rng_pair(1, 96, 160)
    kw = SERVED["C-deploy"][0]
    port = ESMStereoConfidence(ESMStereoConfig(**kw), device="cpu", seed=0)
    bn = port.confidence_net.scale_bn3
    with torch.no_grad():
        bn.weight.copy_(0.75 + 0.5 * torch.rand(
            bn.weight.shape, generator=torch.Generator().manual_seed(1)))
    variables = jax_variables_from_port(port, _jax_shapes("C-deploy"))
    jax_run = _run_jax(jconf.ESMStereoConfidence(JaxConfig(
        **kw, dtype=jnp.bfloat16)), variables, left, right)
    out = {}
    for name, ((disp, conf), aux) in (("jax_bf16", jax_run),
                                      ("fp32", _run_fp32(port, left,
                                                         right))):
        out[name] = {"cost": np.asarray(aux["cost"], np.float32),
                     "disparity": np.asarray(disp, np.float32),
                     "confidence": np.asarray(conf, np.float32)}
    model = ESMStereoConfidence(_deploy(**kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables), _deploy(**kw)))
    for name, op_by_op in (("bf16", False), ("bf16_op_by_op", True)):
        (disp, conf), aux = _run_port(model, left, right, op_by_op)
        assert disp.dtype == aux["cost"].dtype == torch.float32
        out[name] = {"cost": aux["cost"].numpy(), "disparity": disp.numpy(),
                     "confidence": conf.float().numpy()}
    out["dtypes"] = (conf.dtype, jax_run[0][1].dtype)
    return out




@pytest.mark.parametrize("key", ["cost", "disparity", "confidence"])
def test_c_deploy_matches_jax_bf16(c_deploy, key):
    """C-deploy (the confidence model on S-norm at 96x160): its stereo
    submodule's cost and disparity (S-norm-deploy) and the confidence map.
    Inside ``op_by_op_bf16`` (the JAX reference's program as written): no
    further from the JAX C-deploy, in max and in mean, than the JAX
    C-deploy is from the fp32 model (``_run_fp32``) (measured at most 0.88x in max,
    0.63x in mean). As served, its activations rounding once: within
    ``SERVED_TIMES`` that error. The confidence map is bf16, as JAX's
    sigmoid of bf16 logits is, in [0, 1]."""
    j16, j32 = c_deploy["jax_bf16"][key], c_deploy["fp32"][key]
    own = np.abs(j16 - j32)
    shape = {"cost": (1, 12, 6, 10), "disparity": (1, 96, 160),
             "confidence": (1, 96, 160)}[key]
    for name, times in (("bf16_op_by_op", 1.0), ("bf16", SERVED_TIMES)):
        port = c_deploy[name][key]
        assert port.shape == j16.shape == shape and np.isfinite(port).all()
        _no_further(np.abs(port - j16), own, times)
        if key == "confidence":
            assert ((port >= 0) & (port <= 1)).all()
    if key == "confidence":
        assert c_deploy["dtypes"] == (torch.bfloat16, jnp.bfloat16)
