"""PNG files on numpy and the standard library's ``zlib``: the image files
of the datasets and of the renders, without ``imageio``.

``read_png`` decodes non-interlaced PNG at bit depth 8 in colour types 0
(gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA), and at bit
depth 16 in types 0, 2 and 6, with all five row filters. It returns what
``imageio.v2.imread`` returns for such a file: uint8 [H, W] or [H, W, C];
a palette expanded to RGB; 16-bit gray as uint16; 16-bit colour as the
high byte of each sample (uint8); ``tRNS`` ignored. Anything else raises
``ValueError`` and names what it met.

``write_png`` writes 8-bit gray, RGB and RGBA; ``write_apng`` writes an
animated PNG (``acTL`` / ``fcTL`` / ``fdAT``) of such frames, which
``read_png_frames`` reads back.

The Average and Paeth filters take the reconstructed pixel to the left, so
a row cannot be decoded in one vector operation; the decoder walks the
image's anti-diagonals instead (pixel (r, c) needs (r, c - 1), (r - 1, c)
and (r - 1, c - 1), all on earlier diagonals): H + W - 1 vector steps,
each over one pixel of every row it crosses, with every row's own filter.
"""
from __future__ import annotations

import struct
import zlib
from fractions import Fraction
from typing import List, Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {8: (0, 2, 3, 4, 6), 16: (0, 2, 6)}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} truncated")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _header(body: bytes):
    W, H, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} does not exist")
    if depth not in _DEPTHS or ctype not in _DEPTHS[depth]:
        raise ValueError(f"PNG bit depth {depth} in colour type {ctype} is "
                         "not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression method {comp} / filter method "
                         f"{filt} is not supported")
    if interlace != 0:
        raise ValueError("interlaced PNG (Adam7) is not supported")
    if W == 0 or H == 0:
        raise ValueError(f"PNG of size {W} x {H}")
    return H, W, depth, ctype


def unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the row filters: ``raw`` holds the decompressed scanlines
    (a filter-type byte, then W * bpp bytes, per row) -> uint8 [H, W, bpp].

    Pixel (r, c) sits at (r + 1, c + 1) of a zero-padded buffer whose rows
    are W + 1 pixels long, so the pixels of one anti-diagonal are W apart
    in it and every neighbour is a fixed offset away: each step is a
    strided slice."""
    raw = raw.reshape(H, 1 + W * bpp)
    ftype = raw[:, 0]
    if ftype.max() > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} does not "
                         "exist")
    P = np.zeros(((H + 1) * (W + 1), bpp), np.int16)
    X = np.zeros((H + 1, W + 1, bpp), np.int16)
    X[1:, 1:] = raw[:, 1:].reshape(H, W, bpp)
    X = X.reshape(-1, bpp)
    T = np.zeros((H + 1, W + 1), np.uint8)
    T[1:, :] = ftype[:, None]
    T = T.reshape(-1, 1)
    if not np.isin(ftype, (3, 4)).any():
        # no row needs the reconstructed left pixel: row by row
        out = P.reshape(H + 1, W + 1, bpp)
        Xr = X.reshape(H + 1, W + 1, bpp)
        for r in range(H):
            x = Xr[r + 1, 1:]
            if ftype[r] == 1:
                x = np.cumsum(x, axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                x = x + out[r, 1:]
            out[r + 1, 1:] = x & 255
        return out[1:, 1:].astype(np.uint8)
    for d in range(H + W - 1):
        r0, r1 = max(0, d - W + 1), min(H - 1, d)
        start = r0 * W + W + d + 2
        s = slice(start, start + (r1 - r0) * W + 1, W)
        sa = slice(s.start - 1, s.stop - 1, W)
        sb = slice(s.start - W - 1, s.stop - W - 1, W)
        sc = slice(s.start - W - 2, s.stop - W - 2, W)
        a, b, c, t = P[sa], P[sb], P[sc], T[s]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, paeth, 0))))
        P[s] = (X[s] + pred) & 255
    return P.reshape(H + 1, W + 1, bpp)[1:, 1:].astype(np.uint8)


def _decode(H, W, depth, ctype, idat: bytes, palette):
    chans = _CHANNELS[ctype]
    bpp = chans * depth // 8
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not decompress ({e})") from e
    if len(raw) != H * (1 + W * bpp):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{H * (1 + W * bpp)} for {W} x {H}")
    px = unfilter(np.frombuffer(raw, np.uint8), H, W, bpp)
    if depth == 16:
        px = px.reshape(H, W, chans, 2)
        if ctype == 0:
            return (px[..., 0, 0].astype(np.uint16) << 8) | px[..., 0, 1]
        return np.ascontiguousarray(px[..., 0])   # high byte, as imageio
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG palette image without a PLTE chunk")
        if px.max() >= len(palette):
            raise ValueError("PNG palette index out of the PLTE range")
        return palette[px[..., 0]]
    return px[..., 0] if chans == 1 else px


def _read_all(path) -> List:
    """((H, W, depth, ctype), palette, images): ``images`` holds each
    image's compressed data, the default image (IDAT) first."""
    with open(path, "rb") as f:
        data = f.read()
    head = None
    palette = None
    idat, frames, current = [], [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            head = _header(body)
        elif head is None:
            raise ValueError("PNG file does not start with IHDR")
        elif kind == b"PLTE":
            if len(body) % 3:
                raise ValueError("PNG PLTE chunk is not a list of RGB")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"fcTL":
            _, fw, fh, x0, y0 = struct.unpack_from(">IIIII", body)
            if (fw, fh, x0, y0) != (head[1], head[0], 0, 0):
                raise ValueError("animated PNG frame smaller than the image "
                                 "is not supported")
            current = []
            frames.append(current)
        elif kind == b"fdAT":
            if current is None:
                raise ValueError("animated PNG fdAT before any fcTL")
            current.append(body[4:])
    if head is None or not idat:
        raise ValueError("PNG file has no image data")
    frames = [f for f in frames if f]
    return head, palette, [b"".join(idat)] + [b"".join(f) for f in frames]


def read_png(path) -> np.ndarray:
    """The image of a PNG file (the default image of an animated one)."""
    (H, W, depth, ctype), palette, images = _read_all(path)
    return _decode(H, W, depth, ctype, images[0], palette)


def read_png_frames(path) -> np.ndarray:
    """Every frame of an animated PNG written by ``write_apng`` ->
    [T, H, W(, C)]; a still PNG gives one frame."""
    (H, W, depth, ctype), palette, images = _read_all(path)
    return np.stack([_decode(H, W, depth, ctype, im, palette)
                     for im in images])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _as_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        return img[..., None]
    if img.ndim == 3 and img.shape[2] in (3, 4):
        return img
    raise ValueError(f"write_png takes [H, W], [H, W, 1], [H, W, 3] or "
                     f"[H, W, 4] images, got shape {img.shape}")


def filter_rows(img: np.ndarray, filter_type: int) -> bytes:
    """The scanlines of uint8 ``img`` [H, W, C], every row filtered with
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    if filter_type == 0:
        f = x
    elif filter_type == 1:
        f = x - a
    elif filter_type == 2:
        f = x - b
    elif filter_type == 3:
        f = x - ((a + b) >> 1)
    elif filter_type == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        f = x - np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG row filter type {filter_type} does not exist")
    H = img.shape[0]
    rows = np.empty((H, 1 + f[0].size), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = (f & 255).reshape(H, -1)
    return rows.tobytes()


def _ihdr(img: np.ndarray) -> bytes:
    H, W, C = img.shape
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                       {1: 0, 3: 2, 4: 6}[C], 0, 0, 0))


def write_png(path, img, filter_type: int = 1, level: int = 6) -> None:
    """Write uint8 ``img`` ([H, W], [H, W, 1], [H, W, 3] or [H, W, 4]) as
    an 8-bit gray, RGB or RGBA PNG, every row with ``filter_type``."""
    img = _as_image(img)
    data = zlib.compress(filter_rows(img, filter_type), level)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _ihdr(img) + _chunk(b"IDAT", data)
                + _chunk(b"IEND", b""))


def write_apng(path, frames: Sequence, fps: float = 30,
               filter_type: int = 1, level: int = 6) -> None:
    """Write uint8 ``frames`` (each as ``write_png`` takes it, all of one
    shape) as an animated PNG that loops, ``fps`` frames a second; the
    first frame is also the file's still image."""
    frames = [_as_image(f) for f in frames]
    if not frames:
        raise ValueError("write_apng needs at least one frame")
    if any(f.shape != frames[0].shape for f in frames):
        raise ValueError("write_apng frames differ in shape")
    H, W = frames[0].shape[:2]
    delay = Fraction(1 / fps).limit_denominator(65535)
    num, den = delay.numerator, delay.denominator
    out = [SIGNATURE, _ihdr(frames[0]),
           _chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, img in enumerate(frames):
        out.append(_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, W, H, 0, 0, num, den, 0, 0)))
        seq += 1
        data = zlib.compress(filter_rows(img, filter_type), level)
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
