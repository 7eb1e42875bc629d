"""The port's PNG codec (`sam_pt_torch/vos_eval/data/image_io.py`) against
Pillow: files Pillow writes (palette at 1, 2, 4 and 8 bits, grey, RGB,
RGBA, odd widths, short palettes), files a filterer of this test writes
with each of the five row filters (Pillow reads them as the reference),
and the codec's own palette, grey and RGB files read back by Pillow.
Every comparison is exact."""
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from sam_pt_torch.vos_eval.data import image_io

SHAPES = [(29, 45), (7, 1), (16, 33)]  # odd widths and a 1-pixel column


def _random(shape, seed, high=256):
    return np.random.default_rng(seed).integers(0, high, shape).astype(
        np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("colors", [2, 4, 16, 256])
def test_palette_pngs_written_by_pillow(tmp_path, shape, colors):
    """Pillow stores a palette of n <= 16 colours at 1, 2 or 4 bits a
    pixel: the short palettes."""
    file = str(tmp_path / "p.png")
    idx = _random(shape, 1, colors)
    img = Image.fromarray(idx, mode="P")
    img.putpalette(list(_random(3 * colors, 2)))
    img.save(file)
    got, palette = image_io.read_png(file)
    ref = Image.open(file)
    np.testing.assert_array_equal(got, np.array(ref))
    assert palette == ref.getpalette()
    np.testing.assert_array_equal(image_io.read_rgb(file),
                                  np.array(ref.convert("RGB")))
    assert image_io.image_size(file) == shape


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_grey_rgb_rgba_written_by_pillow(tmp_path, shape, channels):
    file = str(tmp_path / "x.png")
    pixels = _random(shape + ((channels,) if channels > 1 else ()), 3)
    Image.fromarray(pixels).save(file)
    got, palette = image_io.read_png(file)
    assert palette is None
    np.testing.assert_array_equal(got, pixels)
    np.testing.assert_array_equal(image_io.read_rgb(file),
                                  np.array(Image.open(file).convert("RGB")))


def _filtered(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """PNG image data for `rows` [H, stride] with row y filtered by
    kinds[y % len(kinds)] (PNG spec, section 9)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        kind = kinds[y % len(kinds)]
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(bytes([kind]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prev = row
    return zlib.compress(b"".join(out))


def _write(file, h, w, ctype, idat, palette=None):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    parts = [b"\x89PNG\r\n\x1a\n",
             chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        parts.append(chunk(b"PLTE", bytes(palette)))
    parts += [chunk(b"IDAT", idat), chunk(b"IEND", b"")]
    with open(file, "wb") as f:
        f.write(b"".join(parts))


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("ctype,channels", [(3, 1), (0, 1), (2, 3), (6, 4)],
                         ids=["palette", "grey", "rgb", "rgba"])
def test_each_row_filter(tmp_path, kinds, ctype, channels):
    h, w = 13, 27
    pixels = _random((h, w, channels), 4)
    file = str(tmp_path / "f.png")
    palette = list(_random(768, 5)) if ctype == 3 else None
    _write(file, h, w, ctype, _filtered(pixels.reshape(h, -1), channels,
                                        kinds), palette)
    got, _ = image_io.read_png(file)
    np.testing.assert_array_equal(got, np.array(Image.open(file)))
    np.testing.assert_array_equal(got.reshape(h, w, channels), pixels)


@pytest.mark.parametrize("shape", SHAPES)
def test_written_pngs_read_back_by_pillow(tmp_path, shape):
    file = str(tmp_path / "w.png")
    idx = _random(shape, 6, 6)
    palette = [0, 0, 0, 128, 0, 0, 0, 128, 0]  # shorter than the indices
    image_io.write_png(file, idx, palette)
    img = Image.open(file)
    assert img.mode == "P"
    np.testing.assert_array_equal(np.array(img), idx)
    assert img.getpalette()[:9] == palette
    assert img.getpalette()[9:] == [0] * (len(img.getpalette()) - 9)
    assert image_io.read_index_mask(file)[0].tolist() == idx.tolist()
    for pixels in (_random(shape, 7), _random(shape + (3,), 8)):
        image_io.write_png(file, pixels)
        np.testing.assert_array_equal(np.array(Image.open(file)), pixels)
        np.testing.assert_array_equal(image_io.read_png(file)[0], pixels)


def test_jpeg_goes_through_pillow(tmp_path, monkeypatch):
    file = str(tmp_path / "00000.jpg")
    Image.fromarray(_random((16, 24, 3), 9)).save(file)
    np.testing.assert_array_equal(image_io.read_rgb(file),
                                  np.array(Image.open(file).convert("RGB")))
    assert image_io.image_size(file) == (16, 24)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="00000.jpg"):
        image_io.read_rgb(file)


def test_corrupt_and_unsupported_files_raise(tmp_path):
    file = str(tmp_path / "c.png")
    image_io.write_png(file, _random((4, 5), 10))
    data = bytearray(open(file, "rb").read())
    data[45] ^= 0xFF  # inside IDAT: its CRC no longer matches
    open(file, "wb").write(bytes(data))
    with pytest.raises(image_io.PngError, match="CRC"):
        image_io.read_png(file)
    Image.fromarray(_random((4, 5, 3), 11)).save(file)
    with pytest.raises(image_io.PngError, match="palette or grey"):
        image_io.read_index_mask(file)
