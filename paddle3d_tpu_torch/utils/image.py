"""Images without an image library: `read_image`, which picks the PNG or
JPEG reader by the file's signature, as `Image.open` does (utils/png.py,
utils/jpeg.py); `resize`, byte for byte Pillow 12's
`Image.resize` of an 8-bit image for BILINEAR and BICUBIC (its default
for RGB), and `flip_left_right` (`Image.FLIP_LEFT_RIGHT`).

Pillow resamples in two separable passes (`libImaging/Resample.c`), the
horizontal one first: each output pixel is a weighted sum over the input
pixels within the filter's support, scaled by the scale factor when
shrinking, with weights normalised to sum to 1, turned into fixed-point
integers of 22 fractional bits, summed in integers from a half, shifted
back and clipped to [0, 255]; the rows between the passes are uint8. Here
the weights are computed in float64 with Pillow's operations in Pillow's
order, and each pass is one gather and one multiply-add a tap, vectorised
over the image.
"""
import os
from typing import Tuple, Union

import numpy as np

from . import jpeg, png

__all__ = ["read_image", "resize", "flip_left_right", "BILINEAR",
           "BICUBIC"]


def _reader(path):
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(png.SIGNATURE):
        return png
    if jpeg.is_jpeg(head):
        return jpeg
    raise ValueError("{}: neither a PNG nor a JPEG file".format(path))


def read_image(path: Union[str, os.PathLike]) -> np.ndarray:
    """The PNG or JPEG at path (by its signature) as [H, W, 3] uint8 RGB,
    as `np.asarray(Image.open(path).convert("RGB"))` gives it."""
    mod = _reader(path)
    return mod.read_png(path) if mod is png else mod.read_jpeg(path)


BILINEAR = "bilinear"
BICUBIC = "bicubic"
PRECISION_BITS = 32 - 8 - 2


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def _weights(in_size: int, out_size: int, resample: str):
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for a box of
    [0, in_size): -> (first input index [out], int32 weights [out, ksize],
    0 past each output's last tap)."""
    fn, support = _FILTERS[resample]
    # (in1 - in0) is a float subtraction in Pillow; exact for sizes < 2^24
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # (int)(v + 0.5): truncation toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = fn((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):          # Pillow's running sum, in tap order
        ww = ww + w[:, k]
    safe = np.where(ww == 0.0, 1.0, ww)[:, None]
    w = np.where(ww[:, None] != 0.0, w / safe, w)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, fixed.astype(np.int32)


def _pass(img: np.ndarray, axis: int, out_size: int, resample: str):
    """One of Pillow's passes along `axis` (0: rows, 1: columns) of a
    uint8 [H, W, C] image."""
    in_size = img.shape[axis]
    xmin, w = _weights(in_size, out_size, resample)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for k in range(w.shape[1]):
        if not w[:, k].any():       # a tap no output pixel weighs
            continue
        tap = np.take(img, np.minimum(xmin + k, in_size - 1),
                      axis=axis).astype(np.int32)
        tap *= w[:, k].reshape(shape)
        acc += tap
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int],
           resample: str = BICUBIC) -> np.ndarray:
    """An [H, W] or [H, W, C] uint8 image at size = (width, height), as
    `Image.fromarray(img).resize(size, resample)` gives it (BILINEAR or
    BICUBIC; Pillow's default for an RGB image is BICUBIC)."""
    if resample not in _FILTERS:
        raise ValueError("resample is {!r}, not one of {}".format(
            resample, sorted(_FILTERS)))
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("resize takes an [H, W] or [H, W, C] uint8 image, "
                         "got {} {}".format(img.dtype, img.shape))
    w_out, h_out = (int(v) for v in size)
    if w_out < 1 or h_out < 1:
        raise ValueError("size {} is empty".format(size))
    flat = img.ndim == 2
    out = img[..., None] if flat else img
    h, w = out.shape[:2]
    if (w_out, h_out) == (w, h):
        return img.copy()
    if w_out != w:
        out = _pass(out, 1, w_out, resample)
    if h_out != h:
        out = _pass(out, 0, h_out, resample)
    return out[..., 0] if flat else out


def flip_left_right(img: np.ndarray) -> np.ndarray:
    """`Image.transpose(Image.FLIP_LEFT_RIGHT)`: columns reversed."""
    return np.ascontiguousarray(np.asarray(img)[:, ::-1])
