"""PyTorch port: kernel J (``ops.kernels.fused_stage``, one whole backbone
stage >= 1) against the JAX package.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there); on CPU tensors the wrapper runs its plain version,
which is what these tests reach. Per stage, the wrapper and the port's
unfused modules are held against the JAX plain flax stage (built as
``tests/test_fused_stage.py`` builds it), the wrapper against the Pallas
kernel in interpret mode on one small case per backbone, and the port's
pyramid with stages 1-5 through ``run_stage`` against JAX's
``FeaturePyramid``. Tolerance: 1e-4 of max(1, max|JAX|), the port's feature
bound. JAX variables come from ``jax.eval_shape`` with seeded numpy values
and cross through ``models/convert_jax.py::convert_tree``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esmstereo_tpu.attic import fused_stage as jfs  # noqa: E402
from esmstereo_tpu.backbones import FeaturePyramid as JaxPyramid  # noqa: E402
from esmstereo_tpu.backbones.efficientnet import ARCHS as JARCHS  # noqa: E402
from esmstereo_tpu_torch.backbones import fused  # noqa: E402
from esmstereo_tpu_torch.backbones.efficientnet import (  # noqa: E402
    ARCHS, DepthwiseSeparable, FeaturePyramid, InvertedResidual)
from esmstereo_tpu_torch.backbones.fused_stage import (  # noqa: E402
    prepare_stage_consts, run_stage, stage_supported)
from esmstereo_tpu_torch.models.convert_jax import convert_tree  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import fused_stage as fs  # noqa: E402
from esmstereo_tpu_torch.ops.kernels import wrappers  # noqa: E402

from test_fused_stage import CASES, _plain_stage  # noqa: E402
from test_torch_kernels import random_variables  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
# the cases of tests/test_fused_stage.py, its odd-height case, and two that
# the JAX lane gate rejects: efficientnet_b2 stage 3 (k3, 4 blocks) to an
# 11 x 19 output and stage 5 (k5, 5 blocks) to 17 x 31 (NHWC shapes)
STAGE_CASES = CASES + [
    ("efficientnet_b2", 1, (1, 40, 64, 16)),
    ("efficientnet_b2", 3, (1, 22, 38, 48)),
    ("efficientnet_b2", 5, (1, 34, 62, 120)),
]
JAX_REJECTS = {("efficientnet_b2", 3), ("efficientnet_b2", 5)}
# Pallas J in interpret mode, one small case a backbone
INTERPRET_CASES = [("efficientnet_b2", 1, (1, 16, 32, 16)),
                   ("mobilenetv2_100", 4, (1, 16, 16, 96))]


@pytest.fixture(scope="module")
def pyramids():
    """Per backbone: seeded JAX pyramid variables and the port's eval
    pyramid on the same weights."""
    out = {}
    for seed, arch in enumerate(ARCHS):
        jp = JaxPyramid(arch=arch)
        shapes = jax.eval_shape(
            lambda x, jp=jp: jp.init(jax.random.key(0), x, train=False),
            jnp.zeros((1, 64, 128, 3), jnp.float32))
        v = random_variables(shapes, np.random.default_rng(10 + seed))
        pyr = FeaturePyramid(arch, device="cpu").eval()
        pyr.load_state_dict(convert_tree(v))
        out[arch] = (v, pyr)
    return out


class StageHolder(torch.nn.Module):
    """The port's blocks of one stage under the pyramid's names, for a stage
    input of any width, with what ``prepare_stage_consts`` reads of a
    pyramid (``block_names``, ``cfg``) and its ``_run_stage``."""

    def __init__(self, arch: str, si: int, cin: int):
        super().__init__()
        self.cfg = ARCHS[arch]
        self.block_names = {si: []}
        for bi, bcfg in enumerate(self.cfg.stages[si]):
            cls = (DepthwiseSeparable if bcfg.kind == "ds"
                   else InvertedResidual)
            name = f"blocks_{si}_{bi}"
            self.add_module(name, cls(bcfg, cin, self.cfg.act, "cpu"))
            self.block_names[si].append(name)
            cin = bcfg.out_chs

    _run_stage = FeaturePyramid._run_stage


def _stage(arch: str, si: int, x: np.ndarray, seed: int,
           zero_bn1_shift: bool = False):
    """The JAX plain stage on NHWC ``x`` with seeded variables (with
    ``zero_bn1_shift``, every ``bn1``'s bias and running mean 0), and the
    port's stage on the same weights: (JAX output, holder, variables)."""
    mod = _plain_stage(arch, si)
    v = random_variables(jax.eval_shape(
        lambda x: mod.init(jax.random.key(0), x, train=False), x),
        np.random.default_rng(seed))
    if zero_bn1_shift:
        for name in v["params"]:
            v["params"][name]["bn1"]["bias"] *= 0.0
            v["batch_stats"][name]["bn1"]["mean"] *= 0.0
    want = np.asarray(jax.jit(lambda v, x: mod.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    holder = StageHolder(arch, si, x.shape[-1]).eval()
    holder.load_state_dict(convert_tree(v))
    return want, holder, v


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> float:
    """Max abs error of ``got`` (NCHW) against ``want`` (NHWC), asserted
    within TOL of max(1, max|want|); returns the tolerance."""
    w = want.transpose(0, 3, 1, 2)
    assert tuple(got.shape) == w.shape, what
    tol = TOL * max(1.0, float(np.abs(w).max()))
    err = float(np.abs(got.numpy() - w).max())
    assert err <= tol, f"{what}: {err:.3e} > {tol:.3e}"
    return tol


def _gap(blind: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(blind.numpy() - want.transpose(0, 3, 1, 2)).max())


def without_se(consts: dict) -> dict:
    return dict(consts, blocks=[{k: t for k, t in b.items()
                                 if not k.startswith("se_")}
                                for b in consts["blocks"]])


def without_residual(consts: dict) -> dict:
    return dict(consts, blocks=[dict(b, residual=False)
                                for b in consts["blocks"]])


@pytest.mark.parametrize("arch,si,shape", STAGE_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_stage_matches_jax(arch, si, shape):
    """The wrapper (its plain version, on the CPU) and the port's unfused
    modules against the JAX plain flax stage; the SE gate, the residual
    and the stride-2 entry's row phase are each seen: the plain version
    without the SE gate, without the residual, or on the input shifted up
    one row (sampling the odd rows at a stride-2 entry) lies at least 100
    tolerances from JAX."""
    stage = ARCHS[arch].stages[si]
    n, h, w, c = shape
    assert stage_supported(stage, c, h, w)
    assert jfs.stage_supported(JARCHS[arch].stages[si], c, w, h) == (
        (arch, si) not in JAX_REJECTS)
    x = np.random.default_rng(si).standard_normal(shape).astype(np.float32)
    want, pyr, _ = _stage(arch, si, x, 10 + si)
    xt = _nchw(x)
    consts = prepare_stage_consts(pyr, si)
    with torch.no_grad():
        tol = _close(fs.fused_stage(xt, consts), want, "wrapper")
        _close(pyr._run_stage(si, xt), want, "modules")
        assert _gap(fs.stage_reference(xt, without_residual(consts)),
                    want) >= 100 * tol
        if ARCHS[arch].stages[si][0].se_ratio > 0:
            assert _gap(fs.stage_reference(xt, without_se(consts)),
                        want) >= 100 * tol
        if stage[0].stride == 2:
            odd = torch.cat([xt[:, :, 1:], xt[:, :, -1:]], dim=2)
            assert _gap(fs.stage_reference(odd, consts), want) >= 100 * tol
    assert fs.fused_stage.launches == 0


def leaky_reference(x: torch.Tensor, consts: dict) -> torch.Tensor:
    """The plain version with the Pallas kernel's padding: each expand also
    runs on k // 2 zero rows above and below its input, so that its
    act(shift) -- not 0 -- fills the depthwise conv's padding rows (its
    columns stay zero). Only inverted-residual blocks."""
    act = fs._FNS[consts["act"]]
    for blk in consts["blocks"]:
        p = blk["k"] // 2
        e = act(F.conv2d(F.pad(x, (0, 0, p, p)), blk["we"][:, :, None, None],
                         blk["be"]))
        d = act(F.conv2d(e, blk["wd"].unsqueeze(1), blk["bd"],
                         stride=blk["stride"], padding=(0, p),
                         groups=blk["mid"]))
        if "se_w1" in blk:
            m = d.mean(dim=(2, 3))
            g = torch.sigmoid(F.linear(act(F.linear(m, blk["se_w1"],
                                                    blk["se_b1"])),
                                       blk["se_w2"], blk["se_b2"]))
            d = d * g[:, :, None, None]
        y = F.conv2d(d, blk["wp"][:, :, None, None], blk["bp"])
        x = y + x if blk["residual"] else y
    return x


def _pallas(arch: str, si: int, x: np.ndarray, v: dict) -> np.ndarray:
    stage = JARCHS[arch].stages[si]
    jconsts = jfs.prepare_stage_consts(
        v["params"], v["batch_stats"], si=si, stage=stage, cin=x.shape[-1],
        w_out=x.shape[2] // stage[0].stride, act=JARCHS[arch].act)
    return np.asarray(jfs.fused_stage_apply(jnp.asarray(x), jconsts,
                                            tile_rows=8, interpret=True))


@pytest.mark.parametrize("arch,si,shape", INTERPRET_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_stage_matches_pallas_interpret(arch, si, shape):
    """The wrapper against ``fused_stage_apply(..., interpret=True)`` (fp32
    operands in interpret mode) and interpret mode against the JAX plain
    stage, with every bn1's shift set to 0 (its bias and running mean; the
    other BNs seeded): see ``test_pallas_interpret_pads_with_the_shift``
    for why."""
    n, h, w, c = shape
    assert jfs.stage_supported(JARCHS[arch].stages[si], c, w, h)
    x = np.random.default_rng(20 + si).standard_normal(shape).astype(
        np.float32)
    plain, pyr, v = _stage(arch, si, x, 30 + si, zero_bn1_shift=True)
    want = _pallas(arch, si, x, v)
    with torch.no_grad():
        _close(fs.fused_stage(_nchw(x), prepare_stage_consts(pyr, si)), want,
               "wrapper against interpret mode")
    _close(torch.from_numpy(want.transpose(0, 3, 1, 2).copy()), plain,
           "interpret mode against the JAX plain stage")


def test_pallas_interpret_pads_with_the_shift():
    """The Pallas kernel lets the expand's act(bn1 shift) into the
    depthwise conv's zero padding at the top and bottom rows (it masks rows
    after the depthwise conv, not before), which its own test cannot see:
    flax's init gives every BN a zero shift. On seeded weights (mobilenetv2
    stage 4) interpret mode agrees with ``leaky_reference`` (the port's
    plain version with that padding) and lies at least 100 tolerances from
    the JAX plain stage, which the wrapper matches."""
    arch, si, shape = INTERPRET_CASES[1]
    x = np.random.default_rng(24).standard_normal(shape).astype(np.float32)
    xt = _nchw(x)
    plain, pyr, v = _stage(arch, si, x, 34)
    want = _pallas(arch, si, x, v)
    with torch.no_grad():
        consts = prepare_stage_consts(pyr, si)
        tol = _close(leaky_reference(xt, consts), want, "leaky padding")
        assert _gap(torch.from_numpy(want.transpose(0, 3, 1, 2).copy()),
                    plain) >= 100 * tol
        _close(fs.fused_stage(xt, consts), plain, "wrapper")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_pyramid_through_run_stage_matches_jax(pyramids, arch):
    """The slice as a whole at 64x128: the port's eval pyramid with kernel
    A's head and stages 1-5 through ``run_stage``, its taps after stages 1,
    2, 4 and 5, against JAX's ``FeaturePyramid``; and the same as the
    served pyramid's forward."""
    v, pyr = pyramids[arch]
    img = np.random.default_rng(7).standard_normal((1, 64, 128, 3)).astype(
        np.float32)
    jp = JaxPyramid(arch=arch)
    want = jax.jit(lambda v, x: jp.apply(v, x, train=False))(
        v, jnp.asarray(img))
    x = _nchw(img)
    with torch.no_grad():
        served = pyr(x)
        y = fused.fused_head(pyr, x)
        feats = [y]
        for si in range(1, 6):
            y = run_stage(pyr, si, y)
            if si in (1, 2, 4, 5):
                feats.append(y)
    assert len(feats) == len(want) == 5
    for i, (g, s, w) in enumerate(zip(feats, served, want)):
        _close(g, np.asarray(w), f"tap {i}")
        _close(s, np.asarray(w), f"served tap {i}")
    assert fs.fused_stage.launches == 0


def test_stage_supported():
    """Every stage 1-5 of both backbones at 544x992 and 384x1248 (JAX's
    version rejects efficientnet_b2's stage 3 at 544x992, the port's takes
    it); mixed SE, a stride-2 block past the entry, an odd size at a
    stride-2 entry, a k7 depthwise and another block kind are rejected."""
    for arch, cfg in ARCHS.items():
        for frame in ((544, 992), (384, 1248)):
            h, w, c = frame[0] // 2, frame[1] // 2, cfg.stages[0][-1].out_chs
            for si in range(1, 6):
                st = cfg.stages[si]
                assert stage_supported(st, c, h, w), (arch, frame, si)
                if st[0].stride == 2:
                    h, w = h // 2, w // 2
                c = st[-1].out_chs
    b2 = ARCHS["efficientnet_b2"].stages
    assert not jfs.stage_supported(JARCHS["efficientnet_b2"].stages[3], 48,
                                   124, 68)
    assert stage_supported(b2[3], 48, 68, 124)
    st = b2[1]
    assert not stage_supported(
        (st[0], dataclasses.replace(st[1], se_ratio=0.0), st[2]), 16, 64, 64)
    assert not stage_supported(
        (st[0], dataclasses.replace(st[1], stride=2)), 16, 64, 64)
    assert not stage_supported(st, 16, 63, 64)
    assert not stage_supported(st, 16, 64, 65)
    assert stage_supported(b2[4], 88, 35, 63)      # stride 1: any size
    assert not stage_supported(
        (dataclasses.replace(st[0], kernel=7),), 16, 64, 64)
    assert not stage_supported(
        (dataclasses.replace(st[0], kind="cn"),), 16, 64, 64)


def test_fused_stage_guards_and_folding(pyramids):
    """The wrapper raises on what the kernel does not take (on the CPU
    too), launches nothing on CPU tensors, is registered, and its consts
    are folded once per set of weights."""
    v, pyr = pyramids["efficientnet_b2"]
    consts = prepare_stage_consts(pyr, 1)
    x = torch.zeros(1, 16, 8, 12)
    with pytest.raises(ValueError):         # odd size at the stride-2 entry
        fs.fused_stage(torch.zeros(1, 16, 7, 12), consts)
    with pytest.raises(ValueError):         # channels
        fs.fused_stage(torch.zeros(1, 24, 8, 12), consts)
    with pytest.raises(TypeError):          # fp32 only
        fs.fused_stage(x.double(), consts)
    with pytest.raises(ValueError):         # one device only
        fs.fused_stage(x.to("meta"), consts)
    with pytest.raises(NotImplementedError):
        fs.fused_stage(x, dict(consts, blocks=[without_se(consts)["blocks"][0],
                                               *consts["blocks"][1:]]))
    with pytest.raises(NotImplementedError):
        fs.fused_stage(x, dict(consts, blocks=[dict(consts["blocks"][0],
                                                    k=7)]))
    with pytest.raises(NotImplementedError):
        fs.fused_stage(x, dict(consts, act="gelu"))
    with pytest.raises(ValueError):         # a weight of the wrong shape
        fs.fused_stage(x, dict(consts, blocks=[dict(
            consts["blocks"][0], wd=consts["blocks"][0]["wd"][:, :2])]))
    with torch.no_grad():
        assert fs.fused_stage(x, consts).shape == (1, 24, 4, 6)
    assert wrappers()["fused_stage"] is fs.fused_stage
    assert fs.fused_stage.launches == 0 and fs.fused_stage.form_launches == {}
    # folded once per set of weights, again after a change
    assert prepare_stage_consts(pyr, 1) is consts
    blk = pyr.blocks_1_0
    saved = blk.bn1.running_var.clone()
    with torch.no_grad():
        blk.bn1.running_var.mul_(4.0)
    changed = prepare_stage_consts(pyr, 1)
    assert changed is not consts
    assert not torch.equal(changed["blocks"][0]["we"],
                           consts["blocks"][0]["we"])
    with torch.no_grad():
        blk.bn1.running_var.copy_(saved)
