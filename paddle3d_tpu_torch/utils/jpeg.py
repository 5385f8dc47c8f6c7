"""JPEG reading without an image library: `read_jpeg(path)` returns an HWC
uint8 RGB array, byte for byte what `np.asarray(PIL.Image.open(p).convert(
"RGB"))` gives with Pillow's libjpeg-turbo (its decompression defaults:
the "islow" integer IDCT, fancy upsampling, fixed-point YCbCr -> RGB).

Supported: baseline and extended sequential Huffman-coded frames (SOF0,
SOF1) of 8-bit samples, 1 (greyscale, copied to three channels, as
`convert("RGB")` does) or 3 components, sampling factors 1 or 2 on each
axis (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals, sizes that are not
a multiple of the MCU, optimised Huffman tables, several sequential
scans. Refused with a ValueError that names the form: progressive,
arithmetic-coded, lossless and hierarchical files, 12-bit samples, 4
components (CMYK, and YCCK: Adobe APP14 transform 2), sampling factors
above 2, a height left to a DNL marker.

The decode (markers, Huffman, dequantisation, IDCT, upsampling, colour)
runs in C++ (`csrc/host/jpeg_decode.cpp`), built with g++ on first use and
called through ctypes, which releases the GIL, so that the loader's
threads decode in parallel (utils/native.py). A failed build raises: there
is no fallback. `decode_jpeg_plain` is the same decode in Python and
NumPy (the Huffman decode a symbol at a time in Python, the IDCT in
integers vectorised over blocks), the reference the tests hold the native
decoder to; it takes seconds for a 1600 x 900 view.

Where byte equality lives:
- the IDCT: jidctint.c's islow (CONST_BITS 13, PASS1_BITS 2) in the
  integer widths of libjpeg-turbo's x86-64 SIMD form, which Pillow runs:
  dequantisation and three sums wrap in 16 bits, each pass saturates to
  16 bits and the result to [-128, 127], and a block with no coefficient
  in rows 1-7 copies its shifted DC through pass 1. The C form's
  range-limit table instead wraps values past +-512 (mod 1024); the two
  agree on every block an encoder of 8-bit samples writes and part on
  crafted out-of-range ones, where this decoder gives Pillow's bytes;
- jdsample.c: h2v1 (3 x near + far, biases 1 / 2, >> 2), h1v2 (biases 1
  above, 2 below), h2v2 (column sums, biases 8 / 7, >> 4), the first and
  last columns' special cases, plain replication where a component is at
  most 2 samples wide (h2v1, h2v2), rows beyond the component clamped to
  its edge (jdmainct.c's context rows);
- jdcolor.c: tables at SCALEBITS 16 with ONE_HALF rounding, saturated;
- jdapimin.c's colour-space guess for 3 components: JFIF -> YCbCr, Adobe
  transform 0 -> RGB, component ids 'R', 'G', 'B' -> RGB, else YCbCr.
"""
import ctypes
import os
from array import array
from typing import Optional, Tuple, Union

import numpy as np

from .native import host_library

__all__ = ["read_jpeg", "decode_jpeg", "decode_jpeg_plain", "jpeg_header",
           "jpeg_size", "is_jpeg", "SIGNATURE"]

SIGNATURE = b"\xff\xd8\xff"

# the native decoder's error codes (jpeg_decode.cpp, enum Err)
_ERRORS = {
    1: "not a JPEG file (no SOI marker)",
    2: "JPEG file truncated",
    3: "unsupported JPEG: progressive (the decoder takes sequential "
       "Huffman-coded frames)",
    4: "unsupported JPEG: arithmetic-coded (the decoder takes Huffman "
       "coding)",
    5: "unsupported JPEG: lossless",
    6: "unsupported JPEG: hierarchical / differential",
    7: "unsupported JPEG: sample precision other than 8 bits",
    8: "unsupported JPEG: component count other than 1 or 3 (CMYK / YCCK)",
    9: "unsupported JPEG: a sampling factor above 2",
    10: "malformed JPEG data",
    11: "JPEG file has no frame or no scan",
    12: "JPEG frame size differs from its header's",
    13: "JPEG scan uses an undefined table",
    14: "unsupported JPEG: height defined by a DNL marker",
}

_SOF_REFUSED = {
    0xC2: 3, 0xC6: 3, 0xC3: 5, 0xC7: 5, 0xC5: 6, 0xC9: 4, 0xCA: 4, 0xCB: 4,
    0xCD: 4, 0xCE: 4, 0xCF: 4}

_fn = None


def _native():
    """The native decoder (csrc/host/jpeg_decode.cpp), bound once."""
    global _fn
    if _fn is None:
        fn = host_library("jpeg_decode.cpp", "p3d_jpeg").p3d_jpeg_decode
        fn.argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def is_jpeg(head: bytes) -> bool:
    """Whether a file's first bytes are a JPEG's (SOI and a marker)."""
    return head[:3] == SIGNATURE


def _segments(data: bytes):
    """(marker, payload start, payload end) of each marker segment to EOI;
    standalone markers give an empty payload. The caller stops at SOS:
    the entropy-coded data follows its header. Raises ValueError on a
    file that is not a JPEG or ends inside a segment."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(_ERRORS[1])
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            return
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            yield marker, pos, pos
            continue
        if pos + 2 > n:
            raise ValueError(_ERRORS[2])
        length = (data[pos] << 8) | data[pos + 1]
        if length < 2 or pos + length > n:
            raise ValueError(_ERRORS[2])
        yield marker, pos + 2, pos + length
        pos += length


def _frame(data: bytes, start: int, end: int, marker: int) -> dict:
    if marker in _SOF_REFUSED:
        raise ValueError(_ERRORS[_SOF_REFUSED[marker]])
    s = data[start:end]
    if len(s) < 6:
        raise ValueError(_ERRORS[10])
    precision, height = s[0], (s[1] << 8) | s[2]
    width, nc = (s[3] << 8) | s[4], s[5]
    if precision != 8:
        raise ValueError(_ERRORS[7] + " ({}-bit)".format(precision))
    if nc not in (1, 3):
        raise ValueError(_ERRORS[8] + " ({} components)".format(nc))
    if height == 0:
        raise ValueError(_ERRORS[14])
    if width == 0 or len(s) < 6 + 3 * nc:
        raise ValueError(_ERRORS[10])
    comps = []
    for i in range(nc):
        cid, hv, tq = s[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 2 and 1 <= v <= 2):
            raise ValueError(_ERRORS[9] + " ({} x {})".format(h, v))
        comps.append({"id": cid, "h": h, "v": v, "tq": tq & 3})
    return {"sof": marker, "width": width, "height": height,
            "components": comps}


def jpeg_header(data: bytes) -> dict:
    """The frame header of a JPEG held in `data` (the bytes up to its SOF
    marker are enough): width, height, components (id, sampling factors,
    quantisation table), the SOF marker and the APP14 Adobe transform
    (None without one). Raises ValueError on a file that is not a JPEG or
    a form the decoder refuses."""
    adobe = None
    for marker, start, end in _segments(data):
        if marker == 0xEE and data[start:start + 5] == b"Adobe" and \
                end - start >= 12:
            adobe = data[start + 11]
            if adobe == 2:
                raise ValueError(_ERRORS[8] + " (Adobe transform 2, YCCK)")
        elif marker == 0xCC:
            raise ValueError(_ERRORS[4])
        elif marker in (0xDE, 0xDF):
            raise ValueError(_ERRORS[6])
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            hdr = _frame(data, start, end, marker)
            hdr["adobe_transform"] = adobe
            return hdr
        elif marker == 0xDA:
            break
    raise ValueError(_ERRORS[11])


def jpeg_size(path: Union[str, os.PathLike]) -> Optional[Tuple[int, int]]:
    """(height, width) from a JPEG's frame header without a decode; None
    if there is no file."""
    try:
        with open(path, "rb") as f:
            head = f.read(65536)
            try:
                hdr = jpeg_header(head)
            except ValueError:
                # a header past the first 64 KiB (a large APP segment)
                hdr = jpeg_header(head + f.read())
    except FileNotFoundError:
        return None
    return hdr["height"], hdr["width"]


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> [H, W, 3] uint8 RGB, with the native
    decoder."""
    hdr = jpeg_header(data)
    h, w = hdr["height"], hdr["width"]
    out = np.empty((h, w, 3), np.uint8)
    src = np.frombuffer(data, np.uint8)
    err = _native()(src.ctypes.data, src.size, out.ctypes.data, w, h)
    if err:
        raise ValueError(_ERRORS.get(err, "JPEG decode error {}".format(
            err)))
    return out


def read_jpeg(path: Union[str, os.PathLike]) -> np.ndarray:
    """The JPEG at path as [H, W, 3] uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_jpeg(data)
    except ValueError as e:
        raise ValueError("{}: {}".format(path, e)) from None


# ------------------------------------------------------------- the plain
# decoder

_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] +
    [63] * 16)
_NATURAL_LIST = _NATURAL.tolist()

def _huffman_table(counts, symbols):
    """A 16-bit-prefix lookup: [65536] of (code length << 8) | symbol, 0
    where no code is a prefix."""
    look = np.zeros(65536, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError(_ERRORS[10])
            shift = 16 - length
            look[code << shift:(code + 1) << shift] = \
                (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return look.tolist()


def _unstuff(data: bytes, start: int):
    """The entropy-coded bytes of a scan from start: -> (list of restart
    intervals' unstuffed bytes, the offset of the marker that ends the
    scan)."""
    out, cur, pos, n = [], bytearray(), start, len(data)
    while pos < n:
        b = data[pos]
        if b != 0xFF:
            cur.append(b)
            pos += 1
            continue
        nb = data[pos + 1] if pos + 1 < n else 0xD9
        if nb == 0x00:
            cur.append(0xFF)
            pos += 2
        elif nb == 0xFF:
            pos += 1                    # a fill byte
        elif 0xD0 <= nb <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            pos += 2
        else:
            break
    out.append(bytes(cur))
    return out, pos


def _windows(chunk: bytes):
    """The 16 bits from every bit position of chunk (zeros past its end,
    as libjpeg supplies at a marker), as an array('H')."""
    bits = np.unpackbits(np.frombuffer(chunk, np.uint8))
    bits = np.concatenate([bits, np.zeros(64, np.uint8)]).astype(np.uint32)
    n = bits.size - 16
    win = np.zeros(n, np.uint32)
    for k in range(16):
        win |= bits[k:k + n] << (15 - k)
    return array("H", win.astype(np.uint16).tobytes())


def _decode_interval(win, nblocks, order, dc_look, ac_look, preds, coefs):
    """Huffman-decode `nblocks` blocks of one restart interval: order[i]
    is (component index, block index) of its i-th block; preds the DC
    predictors (reset by the caller); coefs[c] a flat list receiving
    (index, value) pairs."""
    pos = 0
    natural = _NATURAL_LIST
    for i in range(nblocks):
        c, blk = order[i]
        dl, al = dc_look[c], ac_look[c]
        e = dl[win[pos]]
        if not e:
            raise ValueError(_ERRORS[10])
        pos += e >> 8
        s = e & 0xFF
        if s > 11:
            raise ValueError(_ERRORS[10])
        if s:
            v = win[pos] >> (16 - s)
            pos += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            preds[c] += v
        base = blk * 64
        out = coefs[c]
        # JCOEF is 16-bit
        out.append((base, ((preds[c] + 32768) & 0xFFFF) - 32768))
        k = 1
        while k < 64:
            e = al[win[pos]]
            if not e:
                raise ValueError(_ERRORS[10])
            pos += e >> 8
            rs = e & 0xFF
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if s > 10:
                    raise ValueError(_ERRORS[10])
                v = win[pos] >> (16 - s)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                out.append((base + natural[k], v))
                k += 1
            elif r == 15:
                k += 16
            else:
                break


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x, shift):
    """One 1-D islow pass on x[0..7] (int64 arrays of 16-bit values) in
    the SIMD form's widths: -> 8 outputs descaled by shift (the sum
    wrapped to 32 bits first), saturated to 16 bits."""
    t0 = _wrap16(x[0] + x[4]) * 8192
    t1 = _wrap16(x[0] - x[4]) * 8192
    tmp3 = x[2] * (4433 + 6270) + x[6] * 4433
    tmp2 = x[2] * 4433 + x[6] * (4433 - 15137)
    t10, t13, t11, t12 = t0 + tmp3, t0 - tmp3, t1 + tmp2, t1 - tmp2
    i7, i5, i3, i1 = x[7], x[5], x[3], x[1]
    z3, z4 = _wrap16(i7 + i3), _wrap16(i5 + i1)
    z3p = z3 * (9633 - 16069) + z4 * 9633
    z4p = z3 * 9633 + z4 * (9633 - 3196)
    o0 = i7 * (2446 - 7373) + i1 * -7373 + z3p
    o1 = i5 * (16819 - 20995) + i3 * -20995 + z4p
    o2 = i5 * -20995 + i3 * (25172 - 20995) + z3p
    o3 = i7 * -7373 + i1 * (12299 - 7373) + z4p
    half = np.int64(1) << (shift - 1)
    return [np.clip(((((v + half) + 2**31) & 0xFFFFFFFF) - 2**31) >> shift,
                    -32768, 32767) for v in (
        t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1,
        t11 - o2, t10 - o3)]


def idct_islow_plain(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """The islow IDCT of blocks [N, 64] (16-bit coefficients, natural
    order) under a table quant [64], in libjpeg-turbo's SIMD widths (see
    csrc/host/jpeg_decode.cpp), vectorised over blocks: -> [N, 8, 8]
    uint8."""
    coef = coef.astype(np.int64)
    deq = _wrap16(coef * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.stack(_idct_1d([deq[:, r, :] for r in range(8)], 11), axis=1)
    dc_only = ~np.any(coef[:, 8:] != 0, axis=1)
    dc = _wrap16(deq[:, 0, :] * 4)
    ws = np.where(dc_only[:, None, None], dc[:, None, :], ws)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _upsample_plain(plane, dw, dh, rw, rh, width, height):
    """A component's samples [rows, cols] (dw x dh real) upsampled to
    width x height as jdsample.c does with fancy upsampling."""
    p = plane[:dh, :dw].astype(np.int32)
    if rw == 1 and rh == 1:
        return p[:height, :width]
    if rh == 1:                                         # h2v1
        if dw > 2:
            left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
            right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
            out = np.empty((dh, 2 * dw), np.int32)
            out[:, 0::2] = (3 * p + left + 1) >> 2
            out[:, 1::2] = (3 * p + right + 2) >> 2
        else:
            out = np.repeat(p, 2, axis=1)
        return out[:height, :width]
    if rw == 2 and dw <= 2:                             # h2v2, no context
        return np.repeat(np.repeat(p, 2, axis=0), 2, axis=1)[
            :height, :width]
    rows = np.arange(height)
    near = rows >> 1
    other = np.where(rows & 1, np.minimum(near + 1, dh - 1),
                     np.maximum(near - 1, 0))
    if rw == 1:                                         # h1v2
        bias = np.where(rows & 1, 2, 1)[:, None]
        return (3 * p[near] + p[other] + bias) >> 2
    col = 3 * p[near] + p[other]                        # h2v2
    left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
    right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
    out = np.empty((height, 2 * dw), np.int32)
    out[:, 0::2] = (3 * col + left + 8) >> 4
    out[:, 1::2] = (3 * col + right + 7) >> 4
    return out[:, :width]


def _ycc_rgb_plain(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert on int arrays -> [H, W, 3] uint8."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (91881 * x + half) >> 16
    cb_b = (116130 * x + half) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg_plain(data: bytes) -> np.ndarray:
    """`decode_jpeg` in Python and NumPy (the reference for the native
    decoder): -> [H, W, 3] uint8 RGB."""
    hdr = jpeg_header(data)
    width, height = hdr["width"], hdr["height"]
    comps = hdr["components"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        c["dw"] = -(-width * c["h"] // hmax)
        c["dh"] = -(-height * c["v"] // vmax)
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
        c["coef"] = np.zeros(c["bw"] * c["bh"] * 64, np.int64)
    qt, dc, ac = {}, {}, {}
    restart, jfif, adobe = 0, False, None
    pos, n = 2, len(data)
    scanned = False
    while pos < n:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        length = (data[pos] << 8) | data[pos + 1]
        s = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(s):
                pq, tq = s[i] >> 4, s[i] & 15
                if pq:
                    vals = np.frombuffer(s[i + 1:i + 129], ">u2")
                else:
                    vals = np.frombuffer(s[i + 1:i + 65], np.uint8)
                table = np.zeros(64, np.int64)
                table[_NATURAL[:64]] = vals
                qt[tq] = table
                i += 1 + (128 if pq else 64)
        elif marker == 0xC4:
            i = 0
            while i < len(s):
                tc, th = s[i] >> 4, s[i] & 15
                counts = list(s[i + 1:i + 17])
                nsym = sum(counts)
                look = _huffman_table(counts, list(s[i + 17:i + 17 + nsym]))
                (ac if tc else dc)[th] = look
                i += 17 + nsym
        elif marker == 0xDD:
            restart = (s[0] << 8) | s[1]
        elif marker == 0xE0 and s[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and s[:5] == b"Adobe" and len(s) >= 12:
            adobe = s[11]
        elif marker == 0xDA:
            ns = s[0]
            sc = []
            for i in range(ns):
                ci = next(k for k, c in enumerate(comps)
                          if c["id"] == s[1 + 2 * i])
                td, ta = s[2 + 2 * i] >> 4, s[2 + 2 * i] & 15
                if td not in dc or ta not in ac or \
                        comps[ci]["tq"] not in qt:
                    raise ValueError(_ERRORS[13])
                sc.append((ci, dc[td], ac[ta]))
            if (s[1 + 2 * ns], s[2 + 2 * ns], s[3 + 2 * ns]) != (0, 63, 0):
                raise ValueError(_ERRORS[3])
            # the blocks in scan order: (component, block index)
            if ns == 1:
                c = comps[sc[0][0]]
                nx, ny = -(-c["dw"] // 8), -(-c["dh"] // 8)
                order = [(0, by * c["bw"] + bx) for by in range(ny)
                         for bx in range(nx)]
                per_mcu = 1
            else:
                order = []
                per_mcu = sum(comps[ci]["h"] * comps[ci]["v"]
                              for ci, _, _ in sc)
                for my in range(mcuy):
                    for mx in range(mcux):
                        for k, (ci, _, _) in enumerate(sc):
                            c = comps[ci]
                            for v in range(c["v"]):
                                for h in range(c["h"]):
                                    order.append((k, (my * c["v"] + v) *
                                                  c["bw"] + mx * c["h"] + h))
            intervals, pos = _unstuff(data, pos)
            mcus = len(order) // per_mcu
            step = restart if restart else mcus
            coefs = [[] for _ in sc]
            for j, m0 in enumerate(range(0, mcus, step)):
                m1 = min(m0 + step, mcus)
                chunk = intervals[j] if j < len(intervals) else b""
                preds = [0] * len(sc)
                _decode_interval(_windows(chunk), (m1 - m0) * per_mcu,
                                 order[m0 * per_mcu:m1 * per_mcu],
                                 [d for _, d, _ in sc],
                                 [a for _, _, a in sc], preds, coefs)
            for k, (ci, _, _) in enumerate(sc):
                if coefs[k]:
                    idx, vals = np.asarray(coefs[k], np.int64).T
                    comps[ci]["coef"][idx] = vals
            scanned = True
    if not scanned:
        raise ValueError(_ERRORS[11])
    planes = []
    for c in comps:
        pix = idct_islow_plain(c["coef"].reshape(-1, 64), qt[c["tq"]])
        plane = pix.reshape(c["bh"], c["bw"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        planes.append(_upsample_plain(plane, c["dw"], c["dh"],
                                      hmax // c["h"], vmax // c["v"],
                                      width, height))
    if len(comps) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2).astype(np.uint8)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c["id"] for c in comps] == [82, 71, 66]
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_rgb_plain(*planes)
