"""The port's data layer against the JAX package's numpy-only modules, on
the CPU, array for array.

  * ``data.png``: files written by PIL and by OpenCV (8-bit RGB, grey,
    grey + alpha, RGBA and palette; 16-bit grey), and files whose rows
    carry each of the five filters, read as ``np.array(Image.open(p))``
    and ``np.array(Image.open(p).convert("RGB"))`` read them; files the
    port writes read back through PIL unchanged; interlaced and other
    unsupported files refused;
  * ``data.io``: PFM round trips against JAX's reader and writer, both
    forms and both byte orders;
  * ``data.transforms``: each function from the same generator state;
  * ``data.datasets``: ``SceneFlowDataset.get`` and ``KITTIDataset.get``
    in train and eval mode, on both KITTI roots;
  * ``data.benchmark_loaders``: the path lists and readers on synthetic
    trees;
  * ``data.loader``: batches with threads and with forked processes,
    shuffled and sharded, a worker's error raised in the consumer, and a
    worker process that dies reported;
  * ``utils.visualization`` (OpenCV's JET through the port's own table)
    and ``utils.trees``.
"""

from __future__ import annotations

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from esmstereo_tpu.data import benchmark_loaders as jbl  # noqa: E402
from esmstereo_tpu.data import datasets as jds  # noqa: E402
from esmstereo_tpu.data import io as jio  # noqa: E402
from esmstereo_tpu.data import loader as jloader  # noqa: E402
from esmstereo_tpu.data import transforms as jT  # noqa: E402
from esmstereo_tpu.utils import trees as jtrees  # noqa: E402
from esmstereo_tpu.utils import visualization as jvis  # noqa: E402
from esmstereo_tpu_torch.data import benchmark_loaders as bl  # noqa: E402
from esmstereo_tpu_torch.data import datasets as ds  # noqa: E402
from esmstereo_tpu_torch.data import io  # noqa: E402
from esmstereo_tpu_torch.data import loader  # noqa: E402
from esmstereo_tpu_torch.data import png  # noqa: E402
from esmstereo_tpu_torch.data import transforms as T  # noqa: E402
from esmstereo_tpu_torch.utils import trees  # noqa: E402
from esmstereo_tpu_torch.utils import visualization as vis  # noqa: E402


def assert_same(got, want):
    """Equal trees of arrays (same dtype and shape), numbers and strings."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def textured(rng: np.random.Generator, h: int, w: int, c: int) -> np.ndarray:
    """uint8 smooth noise: neighbouring pixels correlate, so adaptive PNG
    encoders pick every row filter."""
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, c)).astype(
        np.float32)
    return cv2.resize(small, (w, h)).reshape(h, w, c).astype(np.uint8)


# -- PNG -------------------------------------------------------------------

SHAPES = [(1, 1), (5, 3), (17, 29), (64, 96)]
KINDS = ["rgb", "rgba", "grey", "grey_alpha", "grey16", "palette"]


def make_image(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "grey16":
        hi = textured(rng, h, w, 1)[..., 0].astype(np.uint16)
        return hi * 256 + rng.integers(0, 256, (h, w), dtype=np.uint16)
    if kind == "palette":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    c = {"rgb": 3, "rgba": 4, "grey": 1, "grey_alpha": 2}[kind]
    img = textured(rng, h, w, c)
    return img[..., 0] if c == 1 else img


def save_pil(path: str, kind: str, img: np.ndarray) -> None:
    if kind == "palette":
        im = Image.fromarray(img, "P")
        im.putpalette(np.random.default_rng(9).integers(
            0, 256, 768, dtype=np.uint8).tobytes())
    else:
        im = Image.fromarray(img, "LA" if kind == "grey_alpha" else None)
    im.save(path)


def save_cv2(path: str, kind: str, img: np.ndarray) -> None:
    bgr = {"rgb": [2, 1, 0], "rgba": [2, 1, 0, 3]}.get(kind)
    cv2.imwrite(path, np.ascontiguousarray(
        img[..., bgr] if bgr else img))


def assert_reads_as_pil(path: str) -> None:
    want, got = np.array(Image.open(path)), png.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    want_rgb = np.array(Image.open(path).convert("RGB"))
    got_rgb = png.read_rgb(path)
    assert got_rgb.dtype == np.uint8
    np.testing.assert_array_equal(got_rgb, want_rgb)


@pytest.mark.parametrize("kind", KINDS)
def test_png_reads_pil_files(kind, tmp_path):
    for i, (h, w) in enumerate(SHAPES):
        path = str(tmp_path / f"{i}.png")
        save_pil(path, kind, make_image(kind, h, w, i))
        if kind == "palette":
            assert Image.open(path).mode == "P"
        assert_reads_as_pil(path)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey16"])
def test_png_reads_opencv_files(kind, tmp_path):
    for i, (h, w) in enumerate(SHAPES):
        path = str(tmp_path / f"{i}.png")
        save_cv2(path, kind, make_image(kind, h, w, 10 + i))
        assert_reads_as_pil(path)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey_alpha",
                                  "grey16"])
def test_png_writes_what_pil_reads(kind, tmp_path):
    for i, (h, w) in enumerate(SHAPES):
        img = make_image(kind, h, w, 20 + i)
        path = str(tmp_path / f"{i}.png")
        png.write_png(path, img)
        got = np.array(Image.open(path))
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(png.read_png(path), img)


def _filter_rows(img: np.ndarray, kinds: list[int]) -> bytes:
    """The PNG row filters applied byte by byte (the spec's own loops),
    row r with filter ``kinds[r]``."""
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int64)
    bpp = img.shape[2] if img.ndim == 3 else 1
    out = bytearray()
    prior = np.zeros_like(rows[0])
    for r in range(h):
        k, line = kinds[r], rows[r]
        out.append(k)
        for x in range(line.size):
            a = line[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[k]
            out.append((line[x] - pred) % 256)
        prior = line
    return bytes(out)


def _png_file(path: str, w: int, h: int, depth: int, ctype: int,
              raw: bytes, interlace: int = 0) -> None:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 6])
def test_png_each_row_filter(ctype, tmp_path):
    """Rows filtered with None, Sub, Up, Average and Paeth in turn (and
    Paeth after each), decoded as PIL decodes them."""
    c = {0: 1, 2: 3, 6: 4}[ctype]
    img = textured(np.random.default_rng(ctype), 15, 13, c)
    kinds = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 4, 0, 1, 4, 2]
    path = str(tmp_path / "f.png")
    _png_file(path, 13, 15, 8, ctype,
              _filter_rows(img if c > 1 else img[..., 0], kinds))
    assert_reads_as_pil(path)
    np.testing.assert_array_equal(png.read_png(path),
                                  img if c > 1 else img[..., 0])


def test_png_refuses_unsupported(tmp_path):
    path = str(tmp_path / "i.png")
    _png_file(path, 2, 2, 8, 2, b"\0" * 14, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(path)
    cv2.imwrite(path, np.zeros((3, 4, 3), np.uint16))   # 16-bit RGB
    with pytest.raises(ValueError, match="colour type 2 at 16 bits"):
        png.read_rgb(path)
    data = bytearray(open(path, "rb").read())
    data[20] ^= 1                                       # a header byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(path)
    with pytest.raises(ValueError, match="cannot write"):
        png.write_png(path, np.zeros((3, 4, 3), np.uint16))


# -- PFM -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 11), (7, 11, 3)], ids=["Pf", "PF"])
def test_pfm_round_trips(shape, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.standard_normal(shape).astype(np.float32)
    img.flat[0] = np.inf
    for writer, reader in ((io.pfm_imwrite, jio.pfm_imread),
                           (jio.pfm_imwrite, io.pfm_imread),
                           (io.pfm_imwrite, io.pfm_imread)):
        path = str(tmp_path / "d.pfm")
        writer(path, img, scale=2.0)
        got, scale = reader(path)
        assert scale == 2.0
        np.testing.assert_array_equal(got, img)
    # big-endian data: a positive scale
    with open(path, "wb") as f:
        f.write(b"PF\n" if len(shape) == 3 else b"Pf\n")
        f.write(f"{shape[1]} {shape[0]}\n".encode() + b"0.5\n")
        np.flipud(img).astype(">f4").tofile(f)
    got, scale = io.pfm_imread(path)
    want, want_scale = jio.pfm_imread(path)
    assert scale == want_scale == 0.5
    assert_same(got, want)
    np.testing.assert_array_equal(got, img)


def test_io_helpers(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 6, 3)).astype(np.float32) * 3
    assert_same(io.denormalize_image(x), jio.denormalize_image(x))
    u8 = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    assert_same(io.normalize_image(u8), jio.normalize_image(u8))
    path = tmp_path / "list.txt"
    path.write_text("a b c  \n\n  \nd e f\n")
    assert io.read_all_lines(str(path)) == jio.read_all_lines(str(path)) \
        == ["a b c", "d e f"]
    path.write_text("Px\n")
    with pytest.raises(ValueError):
        io.pfm_imread(str(path))


# -- transforms ------------------------------------------------------------

def test_transforms_match_jax():
    rng = np.random.default_rng(3)
    left = textured(rng, 60, 90, 3)
    right = textured(rng, 60, 90, 3)
    disp = rng.uniform(0, 50, (60, 90)).astype(np.float32)
    for f in (0.5, 1.3, 2.0):
        assert_same(T.adjust_brightness(left, f), jT.adjust_brightness(left, f))
        assert_same(T.adjust_gamma(left, f, 0.9), jT.adjust_gamma(left, f, 0.9))
        assert_same(T.adjust_contrast(left, f), jT.adjust_contrast(left, f))
        assert_same(T.adjust_saturation(left, f),
                    jT.adjust_saturation(left, f))
    for seed in range(6):
        calls = [
            lambda m, g: m.asymmetric_chromatic_aug(g, left, right),
            lambda m, g: m.random_crop(g, left, right, disp, (32, 64)),
            lambda m, g: m.random_crop(g, left, right, disp, (80, 128)),
            lambda m, g: m.random_occlusion_patch(g, right, 1.0),
            lambda m, g: m.random_occlusion_patch(g, right[:9, :7], 1.0),
            lambda m, g: m.random_occlusion_patch(g, right, 0.5),
        ]
        for call in calls:
            g1, g2 = (np.random.default_rng(seed) for _ in range(2))
            assert_same(call(T, g1), call(jT, g2))
            assert g1.bit_generator.state == g2.bit_generator.state
    assert_same(T.disparity_pyramid(disp), jT.disparity_pyramid(disp))


# -- datasets and benchmark loaders ------------------------------------------

@pytest.fixture(scope="module")
def trees_root(tmp_path_factory):
    """A SceneFlow list tree (PFM GT), KITTI 2015 and 2012 training trees
    (uint16 GT with invalid zeros), a KITTI raw drive, and scene dirs in
    the Middlebury/ETH3D layout (one without GT and mask, one without
    im1); images written by PIL."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(4)

    def rgb(path, h, w):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(textured(rng, h, w, 3)).save(path)

    def disp16(path, h, w):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        d = (rng.uniform(1, 60, (h, w)) * 256).astype(np.uint16)
        d[rng.random((h, w)) < 0.3] = 0
        Image.fromarray(d).save(path)

    lines = []
    for i in range(3):
        for eye in ("left", "right"):
            rgb(str(root / "sf" / eye / f"{i}.png"), 70, 110)
        os.makedirs(root / "sf" / "disp", exist_ok=True)
        jio.pfm_imwrite(str(root / "sf" / "disp" / f"{i}.pfm"),
                        rng.uniform(1, 60, (70, 110)).astype(np.float32))
        lines.append(f"left/{i}.png right/{i}.png disp/{i}.pfm")
    (root / "sf.txt").write_text("\n".join(lines) + "\n")

    k15, k12 = root / "k15" / "training", root / "k12" / "training"
    kitti = []
    for i in range(2):
        name = f"00000{i}_10.png"
        for side in ("image_2", "image_3"):
            rgb(str(k15 / side / name), 50, 77)
        disp16(str(k15 / "disp_occ_0" / name), 50, 77)
        for side in ("colored_0", "colored_1"):
            rgb(str(k12 / side / name), 47, 80)
        disp16(str(k12 / "disp_occ" / name), 47, 80)
        kitti += [f"training/image_2/{name} training/image_3/{name} "
                  f"training/disp_occ_0/{name}",
                  f"training/colored_0/{name} training/colored_1/{name} "
                  f"training/disp_occ/{name}"]
    (root / "kitti.txt").write_text("\n".join(kitti) + "\n")
    (root / "kitti_test.txt").write_text("\n".join(
        " ".join(line.split()[:2]) for line in kitti) + "\n")

    drive = root / "raw" / "2011_09_26" / "2011_09_26_drive_0001_sync"
    for i in range(2):
        for cam in ("image_02", "image_03"):
            rgb(str(drive / cam / "data" / f"{i:010d}.png"), 8, 8)

    for scene, full in (("sceneA", True), ("sceneB", False)):
        d = root / "scenes" / scene
        rgb(str(d / "im0.png"), 20, 30)
        rgb(str(d / "im1.png"), 20, 30)
        if full:
            disp = rng.uniform(1, 30, (20, 30)).astype(np.float32)
            disp[0, :3] = np.inf
            jio.pfm_imwrite(str(d / "disp0GT.pfm"), disp)
            mask = np.full((20, 30), 255, np.uint8)
            mask[:4] = 128
            Image.fromarray(mask).save(d / "mask0nocc.png")
    rgb(str(root / "scenes" / "sceneC" / "im0.png"), 20, 30)
    return root


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_sceneflow_dataset_matches_jax(trees_root, training):
    args = (str(trees_root / "sf"), str(trees_root / "sf.txt"), training)
    kw = dict(crop=(32, 64), eval_crop=(64, 96))
    got_ds, want_ds = ds.SceneFlowDataset(*args, **kw), \
        jds.SceneFlowDataset(*args, **kw)
    assert len(got_ds) == len(want_ds) == 3
    for i in range(3):
        assert_same(got_ds.get(i, np.random.default_rng(i)),
                    want_ds.get(i, np.random.default_rng(i)))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_kitti_dataset_matches_jax(trees_root, training):
    """Both roots (2015's image_2, 2012's colored_0), the train crop and
    the eval padding, with and without a GT column."""
    roots = (str(trees_root / "k12"), str(trees_root / "k15"))
    lists = ["kitti.txt"] + ([] if training else ["kitti_test.txt"])
    for name in lists:
        args = (*roots, str(trees_root / name), training)
        kw = dict(crop=(32, 64), pad_to=(64, 96))
        got_ds, want_ds = ds.KITTIDataset(*args, **kw), \
            jds.KITTIDataset(*args, **kw)
        assert [got_ds._root(i) for i in range(4)] == \
            [roots[1], roots[0], roots[1], roots[0]]
        for i in range(4):
            got = got_ds.get(i, np.random.default_rng(i))
            assert_same(got, want_ds.get(i, np.random.default_rng(i)))
            assert ("disparity" in got) == (name == "kitti.txt")
    assert set(ds.__datasets__) == set(jds.__datasets__)


def test_benchmark_loaders_match_jax(trees_root):
    k15, k12 = str(trees_root / "k15" / "training"), \
        str(trees_root / "k12" / "training")
    for fn, root in (("kitti_2015_paths", k15), ("kitti_2012_paths", k12)):
        got, want = getattr(bl, fn)(root), getattr(jbl, fn)(root)
        assert got == want and len(got[0]) == 2 and got[1] == []
    args = (str(trees_root / "raw"), "2011_09_26", "0001")
    assert bl.kitti_raw_paths(*args) == jbl.kitti_raw_paths(*args)
    assert len(bl.kitti_raw_paths(*args)) == 2
    scenes = str(trees_root / "scenes")
    for fn in ("eth3d_paths", "middlebury_paths"):
        got = getattr(bl, fn)(scenes)
        assert got == getattr(jbl, fn)(scenes)
        assert [(g is None, m is None) for _, _, g, m in got] == \
            [(False, False), (True, True)]
    lp, _, gtp, maskp = bl.eth3d_paths(scenes)[0]
    assert_same(bl.load_image_u8(lp), jbl.load_image_u8(lp))
    assert_same(bl.load_pfm_disp(gtp), jbl.load_pfm_disp(gtp))
    assert_same(bl.load_nocc_mask(maskp), jbl.load_nocc_mask(maskp))
    dp = bl.kitti_2015_paths(k15)[0][0][2]
    assert_same(bl.load_kitti_disp(dp), jbl.load_kitti_disp(dp))
    x = np.zeros((70, 100, 3))
    assert bl.crop_to_multiple(x).shape == jbl.crop_to_multiple(x).shape \
        == (64, 96, 3)


# -- loader ----------------------------------------------------------------

class _Data:
    """Small samples of every collated kind, drawn from the rng."""

    def __len__(self):
        return 11

    def get(self, index, rng):
        return {"x": rng.standard_normal((3, 2)).astype(np.float32),
                "pyr": [rng.random(2), np.full(1, index)],
                "n": index, "name": f"s{index}"}


class _Broken(_Data):
    def get(self, index, rng):
        if index == 5:
            raise KeyError(f"bad sample {index}")
        return super().get(index, rng)


@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True), dict(shard_index=1, num_shards=3),
    dict(shuffle=True, shard_index=0, num_shards=2, drop_last=False)],
    ids=["ordered", "shuffled", "shard", "shuffled-shard-ragged"])
def test_loader_matches_jax(kw):
    """Threads and forked processes give JAX's batches, epoch by epoch."""
    want_dl = jloader.DataLoader(_Data(), 2, num_workers=2, seed=5, **kw)
    got_dls = [loader.DataLoader(_Data(), 2, num_workers=w, seed=5,
                                 use_processes=p, **kw)
               for w, p in ((1, False), (3, False), (2, True), (4, True))]
    for epoch in (0, 1):
        want_dl.set_epoch(epoch)
        want = list(want_dl)
        assert want and len(want) == len(want_dl)
        for dl in got_dls:
            dl.set_epoch(epoch)
            assert len(dl) == len(want_dl)
            assert_same(list(dl), want)


@pytest.mark.parametrize("processes", [False, True],
                         ids=["threads", "processes"])
def test_loader_worker_error_surfaces(processes):
    dl = loader.DataLoader(_Broken(), 2, num_workers=2,
                           use_processes=processes)
    got = []
    with pytest.raises(KeyError, match="bad sample 5"):
        for batch in dl:
            got.append(batch)
    assert [list(b["n"]) for b in got] == [[0, 1], [2, 3]]
    # an early stop ends the workers, and the next epoch runs
    it = iter(loader.DataLoader(_Data(), 1, num_workers=2,
                                use_processes=processes))
    assert next(it)["n"].tolist() == [0]
    it.close()


class _Crashing(_Data):
    def get(self, index, rng):
        if index == 4:
            os._exit(3)     # a worker killed mid-batch (OOM, a signal)
        return super().get(index, rng)


def test_loader_dead_worker_surfaces(monkeypatch):
    """A forked worker that dies without sending its batch is reported
    with its exit code, not waited for."""
    monkeypatch.setattr(loader, "_POLL_S", 0.2)
    dl = loader.DataLoader(_Crashing(), 2, num_workers=2, use_processes=True)
    with pytest.raises(RuntimeError, match="exit code 3"):
        for _ in dl:
            pass


# -- visualization and trees -----------------------------------------------

def test_visualization_matches_jax():
    rng = np.random.default_rng(6)
    est = rng.uniform(-5, 300, (2, 24, 230)).astype(np.float32)
    gt = rng.uniform(0, 100, (2, 24, 230)).astype(np.float32)
    gt[:, :4] = 0
    assert_same(vis.gen_error_colormap(), jvis.gen_error_colormap())
    assert_same(vis.error_map(est, gt), jvis.error_map(est, gt))
    assert_same(vis.error_map(est[0], gt[0], legend=False),
                jvis.error_map(est[0], gt[0], legend=False))
    for max_disp in (None, 192, 64.5):
        got = vis.colorize_disparity(est[0], max_disp)
        want = np.ascontiguousarray(jvis.colorize_disparity(est[0], max_disp))
        assert_same(got, want)
    ramp = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(
        vis.JET_RGB[None], cv2.applyColorMap(ramp, cv2.COLORMAP_JET)[..., ::-1])


def test_trees():
    tree = {"loss": torch.tensor(1.5), "EPE": [torch.tensor(2.0), 3],
            "d": (np.float32(4.0), None)}
    floats = trees.tensor2float(tree)
    assert floats == {"loss": 1.5, "EPE": [2.0, 3.0], "d": (4.0, None)}
    trees.check_allfloat(floats)
    with pytest.raises(TypeError):
        trees.check_allfloat({"a": [1.0, 2]})
    arrays = trees.tensor2numpy(tree)
    want = jtrees.tensor2numpy({"loss": np.float32(1.5),
                                "EPE": [np.float32(2.0), 3],
                                "d": (np.float32(4.0), None)})
    assert_same(arrays, want)
    assert trees.tensor2float({"a": [np.float64(2.5)]}) == \
        jtrees.tensor2float({"a": [np.float64(2.5)]})
