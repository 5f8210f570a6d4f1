"""PNG read and write with zlib alone (no imaging library).

`read_png` decodes 8-bit gray, gray + alpha, RGB and RGBA images, not
interlaced, with all five row filters, and applies an eXIf orientation tag
as PIL's `ImageOps.exif_transpose` does. Other PNGs raise `UnsupportedPNG`,
so that a caller can hand them to an imaging library where one is
installed. `write_png` writes 8-bit gray or RGB with filter 0.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}        # colour type -> samples a pixel


class UnsupportedPNG(ValueError):
    """A PNG this decoder does not read (palette, 16-bit, interlaced)."""


def _chunks(raw: bytes):
    i = len(SIGNATURE)
    while i + 8 <= len(raw):
        n, tag = struct.unpack(">I4s", raw[i:i + 8])
        yield tag, raw[i + 8:i + 8 + n]
        i += 12 + n
        if tag == b"IEND":
            return


def _unfilter(data: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters. Pixel (r, x) depends on (r, x-1), (r-1, x)
    and (r-1, x-1), so the rows are decoded along anti-diagonals: every
    pixel with r + x = t at once, for t = 0 .. H + W - 2."""
    rows = data.reshape(H, 1 + W * bpp)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise UnsupportedPNG(f"bad PNG row filter {int(ftype.max())}")
    filt = rows[:, 1:].reshape(H, W, bpp).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8)
    out = np.zeros((H + 1, W + 1, bpp), np.int32)   # row 0 and column 0 are zero
    for t in range(H + W - 1):
        r = np.arange(max(0, t - W + 1), min(H, t + 1))
        x = t - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _exif_orientation(exif: bytes) -> int:
    """The TIFF orientation tag (0x0112) of an eXIf chunk, 1 if absent."""
    if len(exif) < 8 or exif[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if exif[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", exif[4:8])
    if ifd + 2 > len(exif):
        return 1
    (n,) = struct.unpack(e + "H", exif[ifd:ifd + 2])
    for k in range(n):
        o = ifd + 2 + 12 * k
        if o + 12 > len(exif):
            break
        tag, typ = struct.unpack(e + "HH", exif[o:o + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(e + "H", exif[o + 8:o + 10])[0]
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """PIL's exif_transpose method for each orientation value."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    if orientation == 5:
        return img.swapaxes(0, 1)
    if orientation == 6:
        return np.rot90(img, -1)
    if orientation == 7:
        return img[::-1, ::-1].swapaxes(0, 1)
    if orientation == 8:
        return np.rot90(img, 1)
    return img


def read_png(path) -> np.ndarray:
    """uint8 (H, W) for gray, else (H, W, C) with C = 2, 3 or 4."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != SIGNATURE:
        raise UnsupportedPNG(f"{path}: not a PNG file")
    hdr, idat, orientation = None, [], 1
    for tag, body in _chunks(raw):
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"eXIf":
            orientation = _exif_orientation(body)
    if hdr is None:
        raise UnsupportedPNG(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise UnsupportedPNG(f"{path}: bit depth {depth}, colour type {ctype}, "
                             f"interlace {interlace} (8-bit gray, gray + alpha, RGB "
                             "or RGBA without interlace are read)")
    bpp = _CHANNELS[ctype]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(data[:H * (1 + W * bpp)], H, W, bpp)
    img = img[..., 0] if bpp == 1 else img
    return np.ascontiguousarray(_orient(img, orientation))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 (H, W) gray or (H, W, 3) RGB image."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    if img.ndim == 3 and img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), got {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_png(img: np.ndarray, path) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
