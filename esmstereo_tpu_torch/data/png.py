"""PNG files read and written with the standard library's ``zlib``.

The port's stand-in for what PIL does in the JAX data path
(``Image.open``, ``convert("RGB")``, ``Image.fromarray(...).save``), so
the port needs neither Pillow nor OpenCV. It covers what the datasets and
the CLIs meet: non-interlaced files of colour type 0 (grey), 2 (RGB),
3 (palette), 4 (grey + alpha) and 6 (RGBA) at 8 bits, and type 0 at 16
bits (KITTI's disparity maps and ``save_disp``'s output), with all five
row filters. Anything else raises ``ValueError``.

``read_png`` gives the array ``np.array(Image.open(path))`` gives (for a
palette file the indices); ``read_rgb`` the one
``np.array(Image.open(path).convert("RGB"))`` gives: grey replicated
(16-bit grey clipped at 255, as PIL converts it), alpha dropped, palette
looked up.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(payload) != length or crc_at + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError("PNG file ends before IEND")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw`` (``h`` rows of a filter byte and
    ``stride`` bytes): (h, stride) uint8.

    A byte depends on the one ``bpp`` to its left, the one above and the
    one above-left, so the pixels are decoded one anti-diagonal at a time:
    ``diag[d + 2, r + 1]`` holds pixel (r, d - r), and each step is a few
    numpy calls over every row at once, branch-free: each row's filter
    (None, Sub, Up, Average, Paeth) weighs the five predictions by 0 or
    1, and Paeth's choice among its three neighbours is arithmetic too."""
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of "
                         "the five")
    if not kinds.any():
        return rows[:, 1:]
    w = stride // bpp
    r = np.arange(h)[:, None]
    d = r + np.arange(w)[None, :]
    filt = np.zeros((h + w, h, bpp), np.int16)
    filt[d, r] = rows[:, 1:].reshape(h, w, bpp)
    # a zero border: the first two diagonals and the row above row 0
    diag = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    weight = {k: np.broadcast_to((kinds == k)[:, None], (h, bpp)).astype(
        np.int16) for k in range(1, 5) if (kinds == k).any()}
    pred, term, avg, pa, pb, pc = (np.empty((h, bpp), np.int16)
                                   for _ in range(6))
    take_a, take_b = np.empty((h, bpp), bool), np.empty((h, bpp), bool)
    for i in range(h + w - 1):
        a = diag[i + 1, 1:]         # left: (r, x - 1)
        b = diag[i + 1, :-1]        # up: (r - 1, x)
        c = diag[i, :-1]            # up-left: (r - 1, x - 1)
        pred.fill(0)
        for k, wk in weight.items():
            if k == 3:
                np.add(a, b, out=avg)
                np.right_shift(avg, 1, out=avg)
                p = avg
            elif k == 4:
                # Paeth: a if |p - a| <= |p - b|, |p - c|; else b if
                # |p - b| <= |p - c|; else c (p = a + b - c)
                np.subtract(b, c, out=pa)       # p - a
                np.subtract(a, c, out=pb)       # p - b
                np.add(pa, pb, out=pc)          # p - c
                np.multiply(pa, np.less_equal(np.abs(pb, out=pb),
                                              np.abs(pc, out=pc),
                                              out=take_b), out=term)
                np.add(term, c, out=term)       # b if take_b else c
                np.abs(pa, out=pa)
                np.less_equal(pa, pb, out=take_a)
                take_a &= np.less_equal(pa, pc, out=take_b)
                np.subtract(a, term, out=pc)
                np.multiply(pc, take_a, out=pc)
                np.add(term, pc, out=term)      # a if take_a
                p = term
            else:
                p = a if k == 1 else b
            np.multiply(p, wk, out=pc)
            np.add(pred, pc, out=pred)
        np.add(filt[i], pred, out=diag[i + 2, 1:])
        np.bitwise_and(diag[i + 2, 1:], 0xFF, out=diag[i + 2, 1:])
    return diag[d + 2, r + 1].astype(np.uint8).reshape(h, stride)


def _decode(path: str):
    """(array as ``np.array(Image.open(path))`` gives it, colour type,
    palette (n, 3) uint8 or None)."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG files are not "
                         "supported")
    if ctype not in CHANNELS or not (
            depth == 8 or (depth == 16 and ctype == 0)):
        raise ValueError(f"{path}: colour type {ctype} at {depth} bits is "
                         "not supported (8-bit types 0, 2, 3, 4, 6 and "
                         "16-bit grey)")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    bpp = CHANNELS[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} image bytes for {w}x{h}")
    img = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    c = CHANNELS[ctype]
    img = img.reshape(h, w, c) if c > 1 else img.reshape(h, w)
    return img, ctype, palette


def read_png(path: str) -> np.ndarray:
    """The image as ``np.array(Image.open(path))``: (H, W) uint8 or uint16
    for grey, (H, W, 2/3/4) for grey + alpha, RGB and RGBA, and the
    (H, W) indices of a palette file."""
    return _decode(path)[0]


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 as ``np.array(Image.open(path).convert("RGB"))``."""
    img, ctype, palette = _decode(path)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[img]
    if ctype == 0:
        return np.repeat(np.minimum(img, 255).astype(np.uint8)[..., None],
                         3, axis=2)
    if ctype == 4:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` as PIL's ``Image.fromarray(img).save(path)`` would
    store it: (H, W) uint8 grey or uint16 16-bit grey, (H, W, 2) grey +
    alpha, (H, W, 3) RGB, (H, W, 4) RGBA, all uint8 but the 16-bit grey.
    Rows are stored unfiltered."""
    img = np.asarray(img)
    types = {2: 0, 3: {2: 4, 3: 2, 4: 6}.get(img.shape[-1])}
    ctype = types.get(img.ndim)
    ok = ctype is not None and (
        img.dtype == np.uint8 or (img.dtype == np.uint16 and img.ndim == 2))
    if not ok:
        raise ValueError(f"cannot write a {img.dtype} array of shape "
                         f"{img.shape} as PNG")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                              ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
