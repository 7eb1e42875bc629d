"""Frame and mask files for the VOS evaluation: the port's own PNG codec
(zlib + numpy), and JPEG through Pillow.

The codec reads non-interlaced PNGs of colour types 0 (grey, 1-8 bits),
2 (RGB), 3 (palette, 1-8 bits) and 6 (RGBA), 8 bits a sample, with all
five row filters; a palette PNG comes back as its index array plus its
palette (a flat [r, g, b, ...] list, as Pillow's `getpalette()` gives
it). It writes grey, palette and RGB PNGs at 8 bits with filter 0. Sub and Up are vectorised a row at a time; Average and
Paeth depend on the byte before in the row and run as a Python loop over
the row (about 0.1-0.2 s for a 480 x 854 palette mask where every row uses
them; the codec's own writer uses filter 0).

JPEG and any other format go through Pillow, imported where such a file
is read: where it is missing, reading one raises an ImportError that
names the file.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


class PngError(ValueError):
    pass


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise PngError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise PngError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PngError(f"{path}: truncated (no IEND)")


def _header(body: bytes, path: str):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise PngError(f"{path}: colour type {ctype} is not supported")
    if interlace:
        raise PngError(f"{path}: interlaced PNGs are not supported")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise PngError(f"{path}: bit depth {depth} for colour type {ctype} "
                       f"is not supported")
    return h, w, depth, ctype


def _unfilter_average(f: List[int], b: List[int], bpp: int) -> List[int]:
    x = [0] * len(f)
    for i in range(bpp):
        x[i] = (f[i] + (b[i] >> 1)) & 255
    for i in range(bpp, len(f)):
        x[i] = (f[i] + ((x[i - bpp] + b[i]) >> 1)) & 255
    return x


def _unfilter_paeth(f: List[int], b: List[int], bpp: int) -> List[int]:
    x = [0] * len(f)
    for i in range(bpp):  # a = c = 0: the predictor is b
        x[i] = (f[i] + b[i]) & 255
    for i in range(bpp, len(f)):
        a, up, c = x[i - bpp], b[i], b[i - bpp]
        pa, pb, pc = abs(up - c), abs(a - c), abs(a + up - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = up
        else:
            pred = c
        x[i] = (f[i] + pred) & 255
    return x


def _unfilter(raw: bytes, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise PngError(f"{path}: image data has {rows.size} bytes, expected "
                       f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if not kinds.any():
        return data
    if int(kinds.max()) > 4:
        raise PngError(f"{path}: unknown row filter {int(kinds.max())}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = kinds[y], data[y]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind == 3:
            cur = np.asarray(_unfilter_average(line.tolist(), prev.tolist(),
                                               bpp), np.uint8)
        else:
            cur = np.asarray(_unfilter_paeth(line.tolist(), prev.tolist(),
                                             bpp), np.uint8)
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> Tuple[np.ndarray, Optional[List[int]]]:
    """(pixels, palette): [H, W] uint8 for grey and palette PNGs (indices
    for palette ones, grey scaled to 0-255 below 8 bits, as Pillow reads
    it), [H, W, C] for RGB and RGBA; the palette of a palette PNG, else
    None."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = _header(body, path)
        elif kind == b"PLTE":
            palette = list(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError(f"{path}: no IHDR chunk")
    h, w, depth, ctype = header
    channels = _CHANNELS[ctype]
    stride = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp, path)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        pixels = (bits.reshape(h, w, depth) * weights).sum(
            -1, dtype=np.uint8)
        if ctype == 0:
            pixels = (pixels.astype(np.int32) * 255 // ((1 << depth) - 1)
                      ).astype(np.uint8)
    else:
        pixels = rows.reshape(h, w, channels)
        if channels == 1:
            pixels = pixels[..., 0]
    if ctype == 3:
        if palette is None:
            raise PngError(f"{path}: palette PNG without a PLTE chunk")
        return np.ascontiguousarray(pixels), palette
    return np.ascontiguousarray(pixels), None


def png_size(path: str) -> Tuple[int, int]:
    """(h, w) from a PNG's header, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise PngError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def write_png(path: str, pixels: np.ndarray,
              palette: Optional[List[int]] = None) -> None:
    """Write uint8 `pixels`: [H, W] as a palette PNG where `palette` (a
    flat [r, g, b, ...] list, padded with black up to the largest index)
    is given, else as grey; [H, W, 3] as RGB. Every row uses filter 0."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8:
        raise PngError(f"{path}: pixels must be uint8, not {pixels.dtype}")
    h, w = pixels.shape[:2]
    if pixels.ndim == 2:
        ctype = 0 if palette is None else 3
    elif pixels.ndim == 3 and pixels.shape[2] == 3:
        ctype = 2
        if palette is not None:
            raise PngError(f"{path}: a palette needs an [H, W] index array")
    else:
        raise PngError(f"{path}: cannot write pixels of shape {pixels.shape}")
    rows = np.zeros((h, 1 + pixels[0].size), np.uint8)
    rows[:, 1:] = pixels.reshape(h, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = [_SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                  0, 0, 0))]
    if ctype == 3:
        entries = max(len(palette) // 3, int(pixels.max()) + 1 if
                      pixels.size else 1)
        plte = bytes(int(v) for v in palette[:3 * entries])
        out.append(chunk(b"PLTE", plte.ljust(3 * entries, b"\0")))
    out.append(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _pillow(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs Pillow, which is not installed (the "
            f"port's own codec reads PNG frames only)") from e
    return Image


def _is_png(path: str) -> bool:
    return path.lower().endswith(".png")


def read_rgb(path: str) -> np.ndarray:
    """A frame as [H, W, 3] uint8 RGB: a PNG through the codec (palette
    colours looked up, alpha dropped), any other file through Pillow."""
    if not _is_png(path):
        with _pillow(path).open(path) as img:
            return np.array(img.convert("RGB"))
    pixels, palette = read_png(path)
    if palette is not None:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette) // 3] = np.asarray(
            palette[:3 * (len(palette) // 3)], np.uint8).reshape(-1, 3)
        return lut[pixels]
    if pixels.ndim == 2:
        return np.repeat(pixels[..., None], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def read_index_mask(path: str) -> Tuple[np.ndarray, Optional[List[int]]]:
    """An annotation PNG as its [H, W] index array and palette (None for a
    grey PNG, whose values are the indices)."""
    pixels, palette = read_png(path)
    if pixels.ndim != 2:
        raise PngError(f"{path}: an index mask must be a palette or grey "
                       f"PNG")
    return pixels, palette


def image_size(path: str) -> Tuple[int, int]:
    """(h, w) of a frame, from its header."""
    if _is_png(path):
        return png_size(path)
    with _pillow(path).open(path) as img:
        return img.size[1], img.size[0]
