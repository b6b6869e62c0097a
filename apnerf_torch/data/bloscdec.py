"""blosc1 frame decoder (port of ``apnerf/data/bloscdec.py``'s decoder).

WIM-preprocessed ZJU caches store each frame's image and mask as a
``blosc.pack_array()`` payload (reference lib/load_zju.py:108-110): a
pickled ndarray compressed into a c-blosc 1.x frame. The ``blosc`` package
is not needed; the frame format is decoded here:

  16-byte header: version, versionlz, flags, typesize (u8),
                  nbytes (i32 LE), blocksize (i32 LE), ctbytes (i32 LE)
  flags: 0x01 byte shuffle, 0x02 pure memcpy, 0x04 bit shuffle,
         0x10 dont-split, bits 5-7 codec format
         (0 = blosclz, 1 = lz4/lz4hc, 2 = snappy, 3 = zlib, 4 = zstd)
  then (unless memcpyed): i32 LE block-start offsets, one per block,
  each block = ``nsplits`` streams of [i32 LE cbytes | payload], where
  cbytes == neblock marks a stored-uncompressed split.

Splitting rule (c-blosc >= 1.11 decoder): typesize streams per block iff
2 <= typesize <= 16, blocksize / typesize >= 128, not the leftover block
and the dont-split flag is clear; else 1 stream. Byte shuffle groups byte
j of every element, applied per block, trailing ``blocksize % typesize``
bytes copied verbatim.

The blosclz token stream is decoded by ``apnerf_torch/native/blosclz.cpp``
(``utils.native``: a failed build raises); ``blosclz_decompress_py`` is
the same decoder in Python, slow, the plain version the tests hold the
library to. Codec 3 (zlib) uses the standard library. Only unpickle caches
you trust.
"""
from __future__ import annotations

import ctypes
import pickle
import struct
import zlib

import numpy as np

from ..utils.native import build_cxx

MAX_DISTANCE = 8191
_FORMAT_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_MIN_BUFFERSIZE = 128
_MAX_SPLITS = 16

_lib = None


def load_library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the blosclz decoder."""
    global _lib
    if _lib is None:
        lib = build_cxx("blosclz.cpp", "apnerf_blosclz")
        lib.apnerf_blosclz_decompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.apnerf_blosclz_decompress.restype = ctypes.c_int64
        _lib = lib
    return _lib


def blosclz_decompress(src: bytes, dst_size: int,
                       force_python: bool = False) -> bytes:
    """Decode one blosclz stream into exactly ``dst_size`` bytes (with
    ``force_python``: through ``blosclz_decompress_py``)."""
    if force_python:
        return blosclz_decompress_py(src, dst_size)
    sbuf = np.frombuffer(src, np.uint8)
    dbuf = np.empty(dst_size, np.uint8)
    n = load_library().apnerf_blosclz_decompress(
        sbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
        dbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dst_size)
    if n != dst_size:
        raise ValueError(
            f"blosclz stream decoded to {n} bytes, expected {dst_size}")
    return dbuf.tobytes()


def blosclz_decompress_py(src: bytes, dst_size: int) -> bytes:
    """The blosclz decoder of ``native/blosclz.cpp`` in Python."""
    ip, ip_end = 0, len(src)
    out = bytearray()
    if ip_end == 0:
        return bytes(out)
    ctrl = src[ip] & 31
    ip += 1
    loop = True
    while loop:
        if ctrl >= 32:
            length = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if length == 6:
                while True:
                    code = src[ip]
                    ip += 1
                    length += code
                    if code != 255:
                        break
            code = src[ip]
            ip += 1
            ref = len(out) - ofs - code
            if code == 255 and ofs == (31 << 8):
                ofs = (src[ip] << 8) + src[ip + 1]
                ip += 2
                ref = len(out) - ofs - MAX_DISTANCE
            if ip < ip_end:
                ctrl = src[ip]
                ip += 1
            else:
                loop = False
            length += 3
            ref -= 1
            if ref < 0:
                raise ValueError("blosclz: reference before output start")
            for _ in range(length):
                out.append(out[ref])
                ref += 1
        else:
            run = ctrl + 1
            out += src[ip:ip + run]
            ip += run
            loop = ip < ip_end
            if loop:
                ctrl = src[ip]
                ip += 1
    if len(out) != dst_size:
        raise ValueError(
            f"blosclz stream decoded to {len(out)} bytes, "
            f"expected {dst_size}")
    return bytes(out)


def _unshuffle(buf: bytes, typesize: int) -> bytes:
    if typesize <= 1:
        return buf
    nel = len(buf) // typesize
    body = nel * typesize
    arr = np.frombuffer(buf[:body], np.uint8).reshape(typesize, nel)
    return arr.T.tobytes() + buf[body:]


def _nsplits(typesize: int, blocksize: int, leftover: bool,
             dont_split: bool) -> int:
    if (1 < typesize <= _MAX_SPLITS and blocksize // typesize
            >= _MIN_BUFFERSIZE and not leftover and not dont_split):
        return typesize
    return 1


def decompress(frame: bytes, force_python: bool = False) -> bytes:
    """``blosc.decompress()`` for blosclz and zlib frames."""
    if len(frame) < 16:
        raise ValueError("blosc frame shorter than its 16-byte header")
    flags, typesize = frame[2], frame[3]
    nbytes, blocksize, ctbytes = struct.unpack_from("<iii", frame, 4)
    if ctbytes > len(frame):
        raise ValueError("blosc frame truncated "
                         f"(header says {ctbytes}, got {len(frame)})")
    if flags & 0x02:  # pure memcpy
        return bytes(frame[16:16 + nbytes])
    if flags & 0x04:
        raise NotImplementedError(
            "the blosc bitshuffle filter is not supported (the WIM ZJU "
            "caches use byte shuffle, the blosc.pack_array default)")
    codec = (flags >> 5) & 0x7
    if codec not in (0, 3):
        raise NotImplementedError(
            f"blosc codec '{_FORMAT_NAMES.get(codec, codec)}' is not "
            "supported (blosclz and zlib are)")
    doshuffle = bool(flags & 0x01) and typesize > 1
    dont_split = bool(flags & 0x10)

    nblocks = max(1, -(-nbytes // blocksize)) if nbytes else 0
    bstarts = struct.unpack_from(f"<{nblocks}i", frame, 16)
    out = bytearray()
    for bi in range(nblocks):
        leftover = bi == nblocks - 1 and nbytes % blocksize != 0
        bsize = nbytes - bi * blocksize if leftover else blocksize
        nsp = _nsplits(typesize, blocksize, leftover, dont_split)
        pos = bstarts[bi]
        block = bytearray()
        for si in range(nsp):
            neblock = bsize // nsp if si < nsp - 1 else bsize - (nsp - 1) * (
                bsize // nsp)
            (cbytes,) = struct.unpack_from("<i", frame, pos)
            pos += 4
            payload = frame[pos:pos + cbytes]
            if len(payload) != cbytes:
                raise ValueError("blosc block truncated")
            pos += cbytes
            if cbytes == neblock:
                block += payload
            elif codec == 3:
                block += zlib.decompress(payload)
            else:
                block += blosclz_decompress(bytes(payload), neblock,
                                            force_python=force_python)
        if len(block) != bsize:
            raise ValueError(
                f"blosc block {bi} decoded to {len(block)} bytes, "
                f"expected {bsize}")
        if doshuffle:
            block = _unshuffle(bytes(block), typesize)
        out += block
    if len(out) != nbytes:
        raise ValueError(
            f"blosc frame decoded to {len(out)} bytes, expected {nbytes}")
    return bytes(out)


def unpack_array(frame: bytes, force_python: bool = False) -> np.ndarray:
    """``blosc.unpack_array()``: decompress, then unpickle."""
    return pickle.loads(decompress(frame, force_python=force_python))
