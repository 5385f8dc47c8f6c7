"""PNG reading without an image library: the chunks parsed, the IDAT
stream inflated with the standard library's zlib, the scanlines unfiltered
by native host code, and the pixels returned as an HWC uint8 RGB array,
byte for byte what `np.asarray(PIL.Image.open(p).convert("RGB"))` gives.

The JAX package decodes with Pillow, which the port does not use. Supported:
non-interlaced 8-bit greyscale, greyscale + alpha, RGB and RGBA (KITTI's
images are 8-bit RGB). Alpha is dropped and grey is copied to the three
channels, as `convert("RGB")` does; a 16-bit, palette, sub-byte or Adam7
interlaced file raises ValueError.

The unfilter (PNG specification, section 9) is sequential along a row for
the Average and Paeth filters, which KITTI's files use: `unfilter` runs it
in C++ (`csrc/host/png_unfilter.cpp`), built with g++ on first use and
called through ctypes, which releases the GIL, so that the loader's
threads decode in parallel (utils/native.py). A failed build raises.
`unfilter_plain` is the same function in Python and NumPy, the reference
the tests hold the native one to.
"""
import ctypes
import os
import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np

from .native import host_library

__all__ = ["read_png", "decode_png", "png_header", "png_size", "inflate",
           "unfilter", "unfilter_plain", "to_rgb"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (8-bit only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale + alpha",
          6: "RGBA"}

_fn = None


def _native():
    """The native unfilter (csrc/host/png_unfilter.cpp, utils/native.py's
    build), bound once."""
    global _fn
    if _fn is None:
        fn = host_library("png_unfilter.cpp", "p3d_png").p3d_png_unfilter
        fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bad_filter(row: int, ftype: int):
    return ValueError("PNG scanline {} has filter type {}, not 0-4".format(
        row, ftype))


def unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct `height` scanlines of `stride` bytes (each led by its
    filter-type byte in `raw`, as inflated) with the native code:
    -> [height, stride] uint8."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (stride + 1):
        raise ValueError("PNG image data holds {} bytes, not {} x {}".format(
            src.size, height, stride + 1))
    out = np.empty((height, stride), np.uint8)
    err = _native()(src.ctypes.data, out.ctypes.data, height, stride, bpp)
    if err:
        raise _bad_filter(err - 1, int(src[(err - 1) * (stride + 1)]))
    return out


def unfilter_plain(raw: bytes, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """`unfilter` in Python and NumPy: None and Up as whole-row copies and
    adds, Sub as a running sum, Average and Paeth a byte at a time as the
    specification writes them (the reference for the native code)."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (stride + 1):
        raise ValueError("PNG image data holds {} bytes, not {} x {}".format(
            src.size, height, stride + 1))
    rows = src.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = line
        elif ftype == 1:
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            out[y] = line + prev
        elif ftype in (3, 4):
            x, b, cur = line.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + b[i]) >> 1
                else:
                    c = b[i - bpp] if i >= bpp else 0
                    p = a + b[i] - c
                    pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b[i] if pb <= pc else c)
                cur[i] = (x[i] + pred) & 0xFF
            out[y] = cur
        else:
            raise _bad_filter(y, ftype)
        prev = out[y]
    return out


def png_header(data: bytes) -> dict:
    """The IHDR fields of a PNG held in `data` (its first 33 bytes are
    enough): width, height, bit_depth, color_type, interlace. Raises
    ValueError on a file that is not a PNG."""
    if len(data) < 33 or data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    width, height, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", data[16:29])
    return {"width": width, "height": height, "bit_depth": depth,
            "color_type": ctype, "compression": comp, "filter": filt,
            "interlace": interlace}


def png_size(path: str) -> Optional[Tuple[int, int]]:
    """(height, width) from a PNG's IHDR chunk; None if there is no file.
    Raises ValueError on a file that is not a PNG."""
    try:
        with open(path, "rb") as f:
            head = f.read(33)
    except FileNotFoundError:
        return None
    try:
        hdr = png_header(head)
    except ValueError:
        raise ValueError("{} is not a PNG file".format(path)) from None
    return int(hdr["height"]), int(hdr["width"])


def _chunks(data: bytes):
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG file truncated (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError("PNG chunk {!r} truncated".format(ctype))
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError("PNG chunk {!r} fails its CRC".format(ctype))
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def inflate(data: bytes):
    """A PNG's header and its inflated image data (the joined IDAT chunks
    through zlib): -> (png_header dict, raw bytes). Raises ValueError on a
    layout this reader does not take."""
    hdr = png_header(data)
    depth, ctype = hdr["bit_depth"], hdr["color_type"]
    if ctype not in _CHANNELS or depth != 8:
        raise ValueError(
            "unsupported PNG: {}-bit {} (the reader takes 8-bit greyscale, "
            "greyscale + alpha, RGB and RGBA)".format(
                depth, _NAMES.get(ctype, "colour type {}".format(ctype))))
    if hdr["interlace"] != 0:
        raise ValueError("unsupported PNG: Adam7 interlaced (the reader "
                         "takes non-interlaced files)")
    if hdr["compression"] != 0 or hdr["filter"] != 0:
        raise ValueError("unsupported PNG: compression method {}, filter "
                         "method {}".format(hdr["compression"],
                                            hdr["filter"]))
    idat = b"".join(p for t, p in _chunks(data) if t == b"IDAT")
    if not idat:
        raise ValueError("PNG file has no IDAT chunk")
    try:
        return hdr, zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError("PNG image data does not inflate: {}".format(
            e)) from None


def to_rgb(pixels: np.ndarray, color_type: int) -> np.ndarray:
    """[H, W * channels] unfiltered bytes -> [H, W, 3] RGB, alpha dropped
    and grey copied to three channels (Pillow's convert("RGB"))."""
    n = _CHANNELS[color_type]
    img = pixels.reshape(pixels.shape[0], -1, n)
    if n == 3:
        return img
    if n == 4:
        return np.ascontiguousarray(img[..., :3])
    return np.repeat(img[..., :1], 3, axis=2)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> [H, W, 3] uint8 RGB."""
    hdr, raw = inflate(data)
    bpp = _CHANNELS[hdr["color_type"]]
    pixels = unfilter(raw, hdr["height"], hdr["width"] * bpp, bpp)
    return to_rgb(pixels, hdr["color_type"])


def read_png(path: Union[str, os.PathLike]) -> np.ndarray:
    """The PNG at path as [H, W, 3] uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError("{}: {}".format(path, e)) from None
