"""PyTorch port: ESMStereo-M and ESMStereo-S with both volumes at the deploy
numerics (bf16 compute, tanh GELU, int8 volume) against the JAX package
(kernel A's mobilenetv2 form writing bf16 and the confidence model are in
tests/test_torch_deploy_confidence.py).

The kernel forms first: B's normalised bf16 forms against
``correlation_volume_folded`` and D's three bf16 forms against
``correlation_volume``, both in interpret mode, within 1 bf16 ulp of each
entry with the bit-exact share stated, and each form's rounding told from
the other's; C's bf16 and int8 forms at CI = 1 (corr_stem) at M's 24 and
S's 12 bins against ``folded_stem_agg_apply`` in interpret mode, within 2
bf16 ulps (the bound of tests/test_torch_deploy.py). Then the port's bf16
activations op by op (``op_by_op_bf16``: ``nn.blocks.set_bf16_per_op``,
whose CPU form is the plain version of the ``activations_bf16`` kernel)
against ``jax.nn``, the configuration's guards, the parameter counts of
M-, M-norm- and S-deploy against the JAX ``eval_shape``, and M-deploy as a
whole model against the JAX bf16 model of its config, both as served and
with the emulation (its int8-volume form against itself). Then
M-norm-deploy-all and S-deploy-all (every ``fuse_*`` switch at the deploy
numerics; the switches' bf16 forms are in
tests/test_torch_deploy_switches.py) against the JAX bf16 programs of
M-norm and S, on the ``eval_shape`` trees the parameter counts use.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each form
against its plain version there); on CPU tensors the wrappers run their
plain versions, which is what these tests reach. Inputs come from
``np.random.default_rng``; each comparison states its tolerance.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from esmstereo_tpu.models import ESMStereo as JaxESMStereo  # noqa: E402
from esmstereo_tpu.models import ESMStereoConfig as JaxConfig  # noqa: E402
from esmstereo_tpu.models import confidence as jconf  # noqa: E402
from esmstereo_tpu.nn import blocks as jblocks  # noqa: E402
from esmstereo_tpu.ops.pallas import correlation as jcorr  # noqa: E402
from esmstereo_tpu.ops.pallas import fused_agg_stem as jfas  # noqa: E402
from esmstereo_tpu_torch.models.confidence import ESMStereoConfidence  # noqa: E402
from esmstereo_tpu_torch.models.convert_jax import state_dict_from_jax  # noqa: E402
from esmstereo_tpu_torch.models.esmstereo import (ESMStereo,  # noqa: E402
                                                  ESMStereoConfig)
from esmstereo_tpu_torch.nn import blocks  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import correlation  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_agg_stem  # noqa: E402
from test_torch_deploy import (C_ULPS, LITERAL_BF16, _flips,  # noqa: E402
                               _nchw_bf16, _ulp, jax_variables_from_port)
from test_torch_fused_aggregation import (_block_tree, _fold,  # noqa: E402
                                          _jax_args, _port_block, _unfold)

torch.set_num_threads(2)

S = dict(cv_scale=16, backbone="mobilenetv2_100")
# the five served deploy configs and their parameters (the JAX eval_shape;
# M, S and C are ACCURACY.json's rows)
SERVED = {"M-deploy": (dict(cv_scale=8), 6_312_625),
          "M-norm-deploy": (dict(cv_scale=8, cost_volume="norm_correlation"),
                            6_305_929),
          "S-deploy": (S, 1_772_986),
          "S-norm-deploy": (dict(S, cost_volume="norm_correlation"),
                            1_722_450),
          "C-deploy": (dict(S, cost_volume="norm_correlation"), 1_814_651)}
SWITCHES = ("fuse_volume_agg", "fuse_hourglass", "fuse_hourglass_up",
            "fuse_stems", "fuse_mixer")


def _deploy(**kw) -> ESMStereoConfig:
    return ESMStereoConfig(dtype="bfloat16", **kw)


def _entry_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of each entry (at the larger magnitude of
    the two; 0 where both are 0)."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return np.abs(got - want) / ulp


# --- kernels B and D in bf16 -------------------------------------------------

# B's normalised bf16 forms, and D's three: (kernel, groups, normalize)
BF16_FORMS = [("B", 32, True), ("B", 1, True), ("D", 32, False),
              ("D", 32, True), ("D", 1, True)]


@functools.cache
def _bf16_descriptors():
    """(1, 4, 13, 64) bf16 descriptor maps, NHWC, seeded."""
    rng = np.random.default_rng(24)
    return tuple(jnp.asarray(rng.standard_normal((1, 4, 13, 64)),
                             jnp.bfloat16) for _ in range(2))


@pytest.mark.parametrize("kernel,groups,normalize", BF16_FORMS,
                         ids=["B-gwc_norm", "B-norm", "D-gwc", "D-gwc_norm",
                              "D-norm"])
def test_correlation_bf16_forms_match_pallas(kernel, groups, normalize):
    """bf16 descriptors (1, 64, 4, 13) (an unaligned width), 12 bins:
    B's normalised forms (``round_products=True``) against
    ``correlation_volume_folded(..., interpret=True)`` and D's forms
    (``round_products=False``) against ``correlation_volume(...,
    interpret=True)``. Every entry within 1 bf16 ulp of itself, and
    bit-exact on at least 99% of the entries (measured: every entry, in
    every form; at a width of 24, one entry of D's norm form in 1152 moved
    by 1 ulp: the fp32 sums of the rounded products are exact in any
    order, and those of the unrounded ones almost always round alike).
    Each form's rounding is seen: the other kernel's rounding moves at
    least 5% of the entries (measured 19.5-21.5%)."""
    ref, tgt = _bf16_descriptors()
    d, w = 12, 13
    with pltpu.force_tpu_interpret_mode():
        if kernel == "B":
            want = jcorr.correlation_volume_folded(ref, tgt, d, groups,
                                                   normalize=normalize,
                                                   interpret=True)
            want = _unfold(np.asarray(want.astype(jnp.float32)), groups)
        else:
            want = jcorr.correlation_volume(ref, tgt, d, groups,
                                            normalize=normalize,
                                            interpret=True)
            want = np.asarray(want.astype(jnp.float32)).transpose(
                0, 4, 1, 2, 3)
    assert want.shape == (1, groups, d, 4, w)
    tr, tt = _nchw_bf16(ref), _nchw_bf16(tgt)
    rounding = kernel == "B"
    got = correlation.correlation_volume(tr, tt, d, groups,
                                         normalize=normalize,
                                         round_products=rounding)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    assert _entry_ulps(got, want).max() <= 1.0
    assert (got == want).mean() >= 0.99, (got == want).mean()
    other = correlation.correlation_volume(tr, tt, d, groups,
                                           normalize=normalize,
                                           round_products=not rounding)
    assert (other.float().numpy() != want).mean() > 0.05


def test_correlation_forms_dispatch():
    """``volume_form`` names each form, the wrapper's plain version
    dispatches by it (fp32: the ``ops.cost_volume`` builders; bf16: B's or
    D's rounding, normalised or not, each a different volume), and the
    wrapper refuses mixed and other dtypes."""
    bf16 = torch.bfloat16
    assert correlation.volume_form(torch.float32, True, False) == "fp32"
    assert [correlation.volume_form(bf16, n, r)
            for r in (True, False) for n in (False, True)] == [
        "bf16", "bf16_norm", "bf16_d", "bf16_d_norm"]
    gen = torch.Generator().manual_seed(3)
    ref = torch.randn((1, 64, 2, 9), generator=gen)
    tgt = torch.randn((1, 64, 2, 9), generator=gen)
    vols = {}
    for n in (False, True):
        for r in (True, False):
            v = correlation.correlation_volume_plain(ref.to(bf16),
                                                     tgt.to(bf16), 4, 32, n,
                                                     r)
            assert v.dtype == bf16
            vols[n, r] = v.float()
        fp32 = correlation.correlation_volume_plain(ref, tgt, 4, 32, n)
        assert fp32.dtype == torch.float32
        # fp32 ignores the rounding switch
        torch.testing.assert_close(fp32, correlation.correlation_volume_plain(
            ref, tgt, 4, 32, n, round_products=False), rtol=0, atol=0)
    for a in vols:
        for b in vols:
            if a != b:
                assert not torch.equal(vols[a], vols[b]), (a, b)
    with pytest.raises(TypeError):
        correlation.correlation_volume(ref.to(bf16), ref, 4, 32)
    with pytest.raises(TypeError):
        correlation.correlation_volume(ref.half(), tgt.half(), 4, 32)
    with pytest.raises(TypeError):
        correlation.volume_form(torch.float16, False)


# --- kernel C's deploy forms at the new shapes -------------------------------

@functools.cache
def _stem_agg_case(ci: int, d: int):
    """ci -> 8 -> 8 at ``d`` bins on 4 x 13 (a ragged width), seeded
    weights and a unit-normal volume: (trees, port blocks, volume (B, C, D,
    H, W) fp32)."""
    rng = np.random.default_rng(7 + ci + d)
    trees = [_block_tree(rng, 3, ci, 8), _block_tree(rng, 3, 8, 8)]
    blocks_ = (_port_block(trees[0], ci, 8, 3, 1, 1),
               _port_block(trees[1], 8, 8, 3, 1, 1))
    vol = rng.standard_normal((1, ci, d, 4, 13)).astype(np.float32)
    return trees, blocks_, vol


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("ci,d", [(1, 24), (1, 12)],
                         ids=["corr_stem-M", "corr_stem-S"])
def test_stem_agg_deploy_forms_match_pallas(ci, d, form):
    """corr_stem (CI = 1) + agg at M's 24 and S's 12 bins
    (tests/test_torch_deploy.py holds group_stem, CI = 32), in tanh GELU,
    as the deploy paths run them: the bf16 form on a bf16 volume, the int8
    form on ``quantize_volume``'s volume writing bf16. Within ``C_ULPS``
    (2) bf16 ulps of max|JAX| of
    ``folded_stem_agg_apply(..., interpret=True)`` (fp32 operands; the
    port's plain forms round them to bf16, as the TPU does)."""
    trees, (stem, agg), vol = _stem_agg_case(ci, d)
    bf16 = torch.bfloat16
    if form == "bf16":
        vin = jnp.asarray(_fold(vol), jnp.bfloat16)
        scale, out = None, None
        tv = torch.from_numpy(np.ascontiguousarray(
            _unfold(np.asarray(vin.astype(jnp.float32)), ci))).to(bf16)
    else:
        vf = jnp.asarray(_fold(vol))
        vmax = jnp.maximum(jnp.max(jnp.abs(vf)), 1e-12)
        vin = jnp.clip(jnp.round(vf * (127.0 / vmax)), -127.0, 127.0).astype(
            jnp.int8)
        scale, out = vmax / 127.0, jnp.bfloat16
        tv, tscale = fused_agg_stem.quantize_volume(torch.from_numpy(vol))
        np.testing.assert_array_equal(tv.numpy(), _unfold(np.asarray(vin),
                                                          ci))
    consts = jfas.prepare_consts(*_jax_args(trees[0]), *_jax_args(trees[1]),
                                 depth=d, gelu_approximate=True,
                                 input_scale=scale)
    want = jfas.folded_stem_agg_apply(vin, consts, out_dtype=out,
                                      interpret=True)
    assert want.dtype == jnp.bfloat16
    want = _unfold(np.asarray(want.astype(jnp.float32)), 8)
    with torch.no_grad():
        tc = fused_agg_stem.prepare_consts(stem, agg, low_precision=True)
        if form == "int8":
            tc = fused_agg_stem.with_input_scale(tc, stem.conv.weight, tscale)
    got = fused_agg_stem.stem_agg(tv, tc, True,
                                  out_dtype=bf16 if form == "int8" else None)
    assert got.dtype == bf16 and got.shape == (1, 8, d, 4, 13)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= C_ULPS * _ulp(float(np.abs(want).max())), err


# --- the bf16 activations ----------------------------------------------------

@contextlib.contextmanager
def op_by_op_bf16():
    """The port's GELU, SiLU, sigmoid and softmax on a bf16 tensor
    computed as ``jax.nn``'s formulas op by op in bf16, each op rounding,
    as XLA computes them with ``xla_allow_excess_precision=False`` (XLA
    expands ``lax.logistic`` into four ops): ``nn.blocks.set_bf16_per_op``,
    whose CPU form is ``ops.kernels.activations.activation_bf16_plain``
    (constants rounded to bf16 as weak-typed floats are); other dtypes
    reach torch's own. Inside the context the port's modules compute the
    JAX reference's program as written; outside it, as served, they round
    once (torch evaluates in fp32)."""
    before = blocks.BF16_PER_OP
    blocks.set_bf16_per_op(True)
    try:
        yield
    finally:
        blocks.set_bf16_per_op(before)


@pytest.mark.parametrize("name", ["gelu_tanh", "gelu_erf", "silu", "sigmoid",
                                  "softmax"])
def test_bf16_activations_match_jax(name):
    """50,000 bf16 values in [-12, 12] through the port's activations
    (``nn.blocks.apply_act`` and ``nn.blocks.softmax``, which the
    confidence head calls): inside ``op_by_op_bf16`` (the plain version of
    the ``activations_bf16`` kernel) they give the bits of ``jax.nn``'s on
    a bf16 array, compiled with ``xla_allow_excess_precision=False`` (all
    of them for every form but the erf GELU, whose ``erfc`` differs on 1
    value in 200,000: at most 1e-4 of the values, by 1 ulp); as the port
    serves them (torch's fp32 function rounded once) they differ from
    those bits on at least 10% of the values (softmax over rows of 8), so
    the per-op mode reaches the port's calls and the whole-model tests
    below can tell the two apart."""
    x = np.random.default_rng(5).uniform(-12, 12, 50_000).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jfns = {"gelu_tanh": lambda a: jax.nn.gelu(a, approximate=True),
            "gelu_erf": lambda a: jax.nn.gelu(a, approximate=False),
            "silu": jax.nn.silu, "sigmoid": jax.nn.sigmoid,
            "softmax": lambda a: jax.nn.softmax(a.reshape(-1, 8), axis=-1)}
    want = np.asarray(jax.jit(jfns[name], compiler_options=LITERAL_BF16)(
        xb).astype(jnp.float32)).ravel()

    def port(t):
        if name == "softmax":
            return blocks.softmax(t.view(-1, 8), 1)
        before = blocks.GELU_APPROXIMATE
        blocks.set_gelu_approximate(name == "gelu_tanh")
        try:
            return blocks.apply_act(t, name.split("_")[0])
        finally:
            blocks.set_gelu_approximate(before)

    t = torch.from_numpy(x).to(torch.bfloat16)
    with op_by_op_bf16():
        literal = port(t)
    served = port(t)
    assert literal.dtype == served.dtype == torch.bfloat16
    literal = literal.float().numpy().ravel()
    assert (literal != want).mean() <= (1e-4 if name == "gelu_erf" else 0.0)
    assert (_entry_ulps(literal, want) <= 1.0).all()
    assert (served.float().numpy().ravel() != want).mean() >= 0.1


# --- the configuration -------------------------------------------------------

def test_deploy_variant_guards():
    """bf16 is accepted at every cv_scale with either volume (and
    ``volume_int8``), and with each ``fuse_*`` switch and all five at each
    scale, with the parameters and keys of the config without them (M-,
    M-norm-, S- and S-norm-deploy's counts); the int8 volume reaches
    kernel C where JAX quantises (M in both volumes, S with gwc; not
    S-norm, whose corr_stem and agg are plain; under ``fuse_volume_agg``
    no volume is stored, so nowhere at cv4 and cv8)."""
    counts = {(kw.get("cv_scale", 4), kw.get("cost_volume", "gwc")): n
              for name, (kw, n) in SERVED.items() if name != "C-deploy"}
    every = dict.fromkeys(SWITCHES, True)
    for cv, backbone in ((4, "efficientnet_b2"), (8, "efficientnet_b2"),
                         (16, "mobilenetv2_100")):
        for volume in ("gwc", "norm_correlation"):
            base = dict(cv_scale=cv, backbone=backbone, cost_volume=volume,
                        volume_int8=True)
            for k in SWITCHES:
                _deploy(**base, **{k: True})
            plain, switched, vol_agg = (
                ESMStereo(_deploy(**base, **sw), device="meta")
                for sw in ({}, every, {"fuse_volume_agg": True}))
            assert switched.state_dict().keys() == plain.state_dict().keys()
            assert _port_count(switched) == _port_count(plain)
            if (cv, volume) in counts:
                assert _port_count(switched) == counts[cv, volume]
            assert switched.volume_int8 == vol_agg.volume_int8 == (
                plain.volume_int8 and cv == 16)
    int8 = {name: ESMStereo(_deploy(**kw, volume_int8=True),
                            device="meta").volume_int8
            for name, (kw, _) in SERVED.items() if name != "C-deploy"}
    assert int8 == {"M-deploy": True, "M-norm-deploy": True,
                    "S-deploy": True, "S-norm-deploy": False}


# --- whole models ------------------------------------------------------------

def _count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def _port_count(model) -> int:
    return sum(p.numel() for p in model.parameters())


@functools.cache
def _jax_shapes(name: str):
    """The JAX ``eval_shape`` variables of a served config (its fp32
    twin: the tree does not depend on the dtype)."""
    kw, _ = SERVED[name]
    cfg = JaxConfig(**kw)
    model = (jconf.ESMStereoConfidence(cfg) if name == "C-deploy"
             else JaxESMStereo(cfg))
    x = np.zeros((1, 32, 64, 3), np.float32)
    return jax.eval_shape(model.init, jax.random.key(0), x, x)


def _rng_pair(seed: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, h, w, 3)).astype(np.float32)
                 for _ in range(2))


def _run_jax(model16, variables, left, right):
    """The JAX bf16 model with tanh GELU (the deploy numerics), with its
    internals; compiled to round where the program says."""
    def run(v, l, r):
        jblocks.set_gelu_approximate(True)
        try:
            return model16.apply(v, l, r, capture_internals=True)
        finally:
            jblocks.set_gelu_approximate(False)

    return jax.jit(run, compiler_options=LITERAL_BF16)(variables, left, right)


def _run_fp32(model, left, right):
    """The port's fp32 model with exact GELU (the reference numerics): the
    fp32 side of the deploy numerics' own error. The port's fp32 models are
    held to JAX's at 1e-4 relative (tests/test_torch_variants.py,
    tests/test_torch_cv16.py, tests/test_torch_confidence.py), which spares
    a second JAX program."""
    with torch.inference_mode():
        return model(torch.from_numpy(left), torch.from_numpy(right),
                     capture_internals=True)


def _run_port(model, left, right, op_by_op: bool = False):
    """The port's deploy model on the pair, in tanh GELU, as served (bf16
    activations rounding once) or, with ``op_by_op``, inside
    ``op_by_op_bf16`` (the JAX reference's program as written)."""
    blocks.set_gelu_approximate(True)
    try:
        with torch.inference_mode(), (op_by_op_bf16() if op_by_op
                                      else contextlib.nullcontext()):
            return model(torch.from_numpy(left), torch.from_numpy(right),
                         capture_internals=True)
    finally:
        blocks.set_gelu_approximate(False)


@pytest.fixture(scope="module")
def m_deploy():
    """One 64x128 pair through the JAX M-deploy (cv8, bf16), the port's M
    in fp32 (``_run_fp32``) and the port's M-deploy and M-deploy-int8, on
    init-rule weights drawn by the port (seed 0) and carried to JAX by the
    bridge run backwards. Returns ``{name: {"cost", "disparity"}}`` as
    numpy fp32."""
    left, right = _rng_pair(0, 64, 128)
    kw = SERVED["M-deploy"][0]
    port = ESMStereo(ESMStereoConfig(**kw), device="cpu", seed=0)
    variables = jax_variables_from_port(port, _jax_shapes("M-deploy"))
    out = {}
    for name, (disp, aux) in (
            ("jax_bf16", _run_jax(JaxESMStereo(JaxConfig(
                **kw, dtype=jnp.bfloat16)), variables, left, right)),
            ("fp32", _run_fp32(port, left, right))):
        out[name] = {"cost": np.asarray(aux["cost"], np.float32),
                     "disparity": np.asarray(disp[0], np.float32)}
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables),
                             _deploy(**kw))
    for name, cfg, op_by_op in (("bf16", _deploy(**kw), False),
                                ("bf16_op_by_op", _deploy(**kw), True),
                                ("int8", _deploy(**kw, volume_int8=True),
                                 False)):
        model = ESMStereo(cfg, device="cpu")
        model.load_state_dict(sd)
        disp, aux = _run_port(model, left, right, op_by_op)
        assert disp[0].dtype == aux["cost"].dtype == torch.float32
        out[name] = {"cost": aux["cost"].numpy(),
                     "disparity": disp[0].numpy()}
    return out


def check_parameter_count(name: str, shapes) -> None:
    """The served deploy config ``name``'s parameters (fp32, as BN
    statistics) number what the JAX ``eval_shape`` (``shapes``) counts, and
    the bridge maps that tree onto the bf16 model key for key."""
    kw, want = SERVED[name]
    cls = ESMStereoConfidence if name == "C-deploy" else ESMStereo
    model = cls(_deploy(**kw), device="meta")
    assert _count(shapes["params"]) == _port_count(model) == want
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert state_dict_from_jax(zeros, _deploy(**kw)).keys() == \
        model.state_dict().keys()


@pytest.mark.parametrize("name", ["M-deploy", "M-norm-deploy", "S-deploy"])
def test_deploy_parameter_counts(name):
    """M-deploy, M-norm-deploy and S-deploy against their JAX trees
    (``check_parameter_count``; C-deploy and S-norm-deploy in
    tests/test_torch_deploy_confidence.py)."""
    check_parameter_count(name, _jax_shapes(name))


def _no_further(ours: np.ndarray, own: np.ndarray, times: float = 1.0
                ) -> None:
    assert ours.max() <= times * own.max(), (ours.max(), own.max())
    assert ours.mean() <= times * own.mean(), (ours.mean(), own.mean())


# The port as served, its bf16 activations rounding once, against the JAX
# reference that rounds after each op: measured at most 1.52x (max) and
# 1.01x (mean) of the deploy numerics' own error, both on M's disparity.
# "No further than 1x" holds for the op-by-op run only.
SERVED_TIMES = 2.0


@pytest.mark.parametrize("key", ["cost", "disparity"])
def test_m_deploy_matches_jax_bf16(m_deploy, key):
    """M-deploy's cost (continuous, before regression) and disparity (cv8
    regresses the raw cost, so it is continuous too), finite and fp32.
    Inside ``op_by_op_bf16``, which computes the JAX reference's program as
    written: no further from the JAX M-deploy, in max and in mean, than the
    JAX M-deploy is from the fp32 model (``_run_fp32``; the deploy
    numerics' own error; measured 0.73x and 0.86x on the cost, 0.36x and 0.01x on the
    disparity). As served, its activations rounding once: within
    ``SERVED_TIMES`` that error."""
    j16, j32 = m_deploy["jax_bf16"][key], m_deploy["fp32"][key]
    own = np.abs(j16 - j32)
    for name, times in (("bf16_op_by_op", 1.0), ("bf16", SERVED_TIMES)):
        port = m_deploy[name][key]
        assert port.shape == j16.shape == {"cost": (1, 24, 8, 16),
                                           "disparity": (1, 64, 128)}[key]
        assert np.isfinite(port).all()
        _no_further(np.abs(port - j16), own, times)


def test_m_deploy_int8_near_m_deploy(m_deploy):
    """M-deploy-int8 against the port's own M-deploy: the 95th percentile
    of the disparity difference under 1 px (or under the bf16 numerics'
    own 95th percentile against fp32, where larger), the cost moved by the
    int8 volume, and under tests/test_bf16.py's 5% of pixels off by more
    than 1 px."""
    q, b = m_deploy["int8"], m_deploy["bf16"]
    own = np.quantile(np.abs(m_deploy["jax_bf16"]["disparity"]
                             - m_deploy["fp32"]["disparity"]), 0.95)
    q95 = np.quantile(np.abs(q["disparity"] - b["disparity"]), 0.95)
    assert np.isfinite(q["disparity"]).all()
    assert q95 < max(1.0, own), (q95, own)
    assert np.abs(q["cost"] - b["cost"]).max() > 0.0
    assert _flips(q["disparity"], b["disparity"])[0] < 0.05


# --- M-norm-deploy-all and S-deploy-all: every switch at the deploy numerics -

# the whole-model cases: name -> the served deploy config they switch on
SWITCHED = {"M-norm-deploy-all": "M-norm-deploy", "S-deploy-all": "S-deploy"}
# their costs at 64x128: 24 bins on the /8 grid, 12 on the /16 one
COST_SHAPES = {"M-norm-deploy-all": (1, 24, 8, 16),
               "S-deploy-all": (1, 12, 4, 8)}
# Against the JAX bf16 program, in multiples of the deploy numerics' own
# error: the op-by-op run at 1x and the served one at SERVED_TIMES, as
# M-deploy, except M-norm-deploy-all's op-by-op run, whose kernel forms
# round where the TPU kernels do, not where JAX's plain modules do
# (measured: M-norm-deploy-all 1.31x in max and 1.04x in mean on the
# cost, 1.03x in max on the disparity, in both runs; S-deploy-all 1.07x in
# max on the served disparity, 0.54x at most op by op).
TIMES = {("M-norm-deploy-all", "bf16_op_by_op"): SERVED_TIMES}


@pytest.fixture(scope="module")
def switched():
    """One 64x128 pair through the JAX bf16 programs (tanh GELU) of M-norm
    and S (one program; the switches change nothing there on the CPU) and
    through the port: each config in fp32 with exact GELU (``_run_fp32``)
    and with every switch at the deploy numerics, as
    served and inside ``op_by_op_bf16``. Init-rule weights drawn by the
    port (seed 0), carried to JAX by the bridge run backwards. Returns
    ``{case: {run: {"cost", "disparity"}}}`` as numpy fp32."""
    left, right = _rng_pair(0, 64, 128)
    cases, jmodels, jvars = {}, [], []
    for name, served in SWITCHED.items():
        kw = SERVED[served][0]
        fp32 = ESMStereo(ESMStereoConfig(**kw), device="cpu", seed=0)
        cases[name] = (kw, fp32)
        jvars.append(jax_variables_from_port(fp32, _jax_shapes(served)))
        jmodels.append(JaxESMStereo(JaxConfig(**kw, dtype=jnp.bfloat16)))

    def run(vs, l, r):
        jblocks.set_gelu_approximate(True)
        try:
            return [m.apply(v, l, r, capture_internals=True)
                    for m, v in zip(jmodels, vs)]
        finally:
            jblocks.set_gelu_approximate(False)

    runs = jax.jit(run, compiler_options=LITERAL_BF16)(jvars, left, right)
    out = {}
    for (name, (kw, fp32)), (disp, aux), v in zip(cases.items(), runs,
                                                  jvars):
        res = {"jax_bf16": {"cost": np.asarray(aux["cost"], np.float32),
                            "disparity": np.asarray(disp[0], np.float32)}}
        d32, a32 = _run_fp32(fp32, left, right)
        res["fp32"] = {"cost": a32["cost"].numpy(),
                       "disparity": d32[0].numpy()}
        config = _deploy(**kw, **dict.fromkeys(SWITCHES, True))
        model = ESMStereo(config, device="cpu")
        model.load_state_dict(state_dict_from_jax(
            jax.tree.map(np.asarray, v), config))
        for run_name, op_by_op in (("bf16", False), ("bf16_op_by_op", True)):
            d, a = _run_port(model, left, right, op_by_op)
            assert d[0].dtype == a["cost"].dtype == torch.float32
            res[run_name] = {"cost": a["cost"].numpy(),
                             "disparity": d[0].numpy()}
        out[name] = res
    return out


@pytest.mark.parametrize("key", ["cost", "disparity"])
@pytest.mark.parametrize("name", list(SWITCHED))
def test_switched_deploy_matches_jax_bf16(switched, name, key):
    """M-norm-deploy-all's and S-deploy-all's cost (before regression) and
    disparity (cv8 and cv16 regress the raw cost: continuous), finite and
    fp32, against the JAX bf16 program, as
    tests/test_torch_deploy_variants.py holds M-deploy: inside
    ``op_by_op_bf16`` no further, in max and in mean, than the deploy
    numerics' own error (the JAX bf16 run against the fp32 one); as served,
    its activations rounding once, within ``SERVED_TIMES`` that error;
    M-norm-deploy-all's op-by-op run within ``TIMES`` that error."""
    runs = switched[name]
    j16 = runs["jax_bf16"][key]
    own = np.abs(j16 - runs["fp32"][key])
    shape = COST_SHAPES[name] if key == "cost" else (1, 64, 128)
    for run, served in (("bf16_op_by_op", 1.0), ("bf16", SERVED_TIMES)):
        times = TIMES.get((name, run), served)
        port = runs[run][key]
        assert port.shape == j16.shape == shape
        assert np.isfinite(port).all()
        _no_further(np.abs(port - j16), own, times)

