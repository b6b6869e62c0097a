"""The port's PNG codec (``utils/png.py``) and area resize
(``utils/image.py``) against the libraries the JAX package reads images
with: decodes bit-equal to ``imageio.v2.imread`` (files written by
imageio / Pillow, which picks the row filters itself, and by cv2 at 16
bits), and to the image on files the port wrote with each filter forced;
every write round-trips; the animated PNG reads back frame by frame, here
and through Pillow; ``area_resize`` within one level of
``cv2.resize(INTER_AREA)`` for uint8 and 1e-6 for float32."""
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from apnerf_torch.render import metrics as tmetrics
from apnerf_torch.render import render as trender
from apnerf_torch.utils import png
from apnerf_torch.utils.image import area_resize


def smooth(h, w, c, seed=0):
    """A photo-like uint8 image (waves and noise), on which Pillow's
    adaptive choice takes Sub, Up and Paeth rows."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = (127 + 60 * np.sin(x / 3.0) + 60 * np.cos(y / 4.0))[..., None] \
        + rng.integers(0, 20, (h, w, c))
    return img.clip(0, 255).astype(np.uint8)


def filter_types(path):
    """The row filter types of a non-interlaced 8-bit PNG."""
    with open(path, "rb") as f:
        data = f.read()
    idat, pos, head = b"", 8, None
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    W, H, depth, ctype = head[:4]
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(H, 1 + W * bpp)[:, 0].tolist())


@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgb", "rgba",
                                  "palette", "gray16"])
def test_decode_vs_imageio(kind, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    img = smooth(37, 53, 4, seed=1)
    if kind == "gray":
        imageio.imwrite(path, img[..., 0])
    elif kind == "gray_alpha":
        Image.fromarray(img[..., :2], "LA").save(path)
    elif kind == "rgb":
        imageio.imwrite(path, img[..., :3])
    elif kind == "rgba":
        imageio.imwrite(path, img)
    elif kind == "palette":
        Image.fromarray(img[..., :3]).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=40).save(
                path, transparency=3)
    else:
        imageio.imwrite(path, (img[..., 0].astype(np.uint16) * 257
                               + np.arange(53, dtype=np.uint16)))
    want = imageio.imread(path)
    got = png.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kind in ("rgb", "rgba"):
        # Pillow's adaptive mix, Paeth (the left pixel) included
        assert {1, 2, 4} <= filter_types(path)


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_16bit_colour_vs_imageio(channels, tmp_path):
    """16-bit RGB / RGBA (written by cv2): the high byte of each sample,
    as imageio (Pillow) reads them."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 65536, (9, 14, channels)).astype(np.uint16)
    path = str(tmp_path / "c16.png")
    cv2.imwrite(path, img)
    want = imageio.imread(path)
    got = png.read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_forced_filters_round_trip(filter_type, channels, tmp_path):
    """The port's writer with every row taking one filter: the port and
    imageio both decode the image."""
    img = smooth(23, 31, channels, seed=filter_type)
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / "f.png")
    png.write_png(path, img, filter_type=filter_type)
    assert filter_types(path) == {filter_type}
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


def test_mixed_filters_of_every_type(tmp_path):
    """Rows of all five filters in one image (the anti-diagonal walk
    with a different filter a row), against imageio."""
    img = smooth(40, 29, 4, seed=5)
    rows = [png.filter_rows(img[r:r + 1] if r == 0 else img[r - 1:r + 1],
                            r % 5) for r in range(len(img))]
    stride = 1 + img.shape[1] * 4
    raw = b"".join(r if i == 0 else r[stride:] for i, r in enumerate(rows))
    path = str(tmp_path / "mixed.png")
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + png._ihdr(img)
                + png._chunk(b"IDAT", zlib.compress(raw))
                + png._chunk(b"IEND", b""))
    assert filter_types(path) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_animated_png_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (5, 12, 17, 3)).astype(np.uint8)
    path = str(tmp_path / "video.png")
    png.write_apng(path, frames, fps=30)
    got = png.read_png_frames(path)
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(png.read_png(path), frames[0])
    with Image.open(path) as im:               # an independent reader
        assert im.n_frames == 5
        for i in range(5):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          frames[i])


def test_write_video_without_imageio_and_cv2(tmp_path, monkeypatch, capsys):
    """Neither encoder imports: an animated PNG beside the asked path."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setattr(trender, "cv2", None)
    frames = np.random.default_rng(4).random((4, 8, 10, 3))
    out = trender.write_video(str(tmp_path / "v.rgb.mp4"), frames, fps=4)
    assert out == str(tmp_path / "v.rgb.png")
    assert "animated PNG" in capsys.readouterr().out
    np.testing.assert_array_equal(png.read_png_frames(out),
                                  tmetrics.to8b(frames))


def test_unsupported_files_raise(tmp_path):
    img = smooth(6, 7, 3)
    path = tmp_path / "a.png"
    png.write_png(str(path), img)
    data = bytearray(path.read_bytes())
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data[:-30]))                    # truncated
    with pytest.raises(ValueError, match="truncated|IEND"):
        png.read_png(str(bad))
    crc = bytearray(data)
    crc[20] ^= 1                                          # IHDR corrupted
    bad.write_bytes(bytes(crc))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(bad))
    Image.fromarray(img[..., 0] > 100).save(str(bad))     # bit depth 1
    with pytest.raises(ValueError, match="bit depth 1"):
        png.read_png(str(bad))
    ihdr = bytearray(data[16:29])
    ihdr[12] = 1                                          # Adam7
    inter = (bytes(data[:8]) + png._chunk(b"IHDR", bytes(ihdr))
             + bytes(data[33:]))
    bad.write_bytes(inter)
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(str(bad))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(bad), img.astype(np.float32))


@pytest.mark.parametrize("factor", [2, 4, 1.5, 2.7])
@pytest.mark.parametrize("shape", [(81, 108, 3), (64, 96, 4), (75, 54)])
def test_area_resize_vs_cv2(factor, shape):
    rng = np.random.default_rng(int(factor * 10))
    img8 = rng.integers(0, 256, shape).astype(np.uint8)
    h, w = int(round(shape[0] / factor)), int(round(shape[1] / factor))
    want = cv2.resize(img8, (w, h), interpolation=cv2.INTER_AREA)
    got = area_resize(img8, (w, h))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    imgf = (img8 / 255.0).astype(np.float32)
    want = cv2.resize(imgf, (w, h), interpolation=cv2.INTER_AREA)
    got = area_resize(imgf, (w, h))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_area_resize_downscales_only():
    img = np.zeros((8, 8, 3), np.uint8)
    np.testing.assert_array_equal(area_resize(img, (8, 8)), img)
    with pytest.raises(ValueError, match="downscales"):
        area_resize(img, (16, 8))
