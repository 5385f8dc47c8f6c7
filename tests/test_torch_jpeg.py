"""The port's JPEG reader (utils/jpeg.py, csrc/host/jpeg_decode.cpp)
against Pillow 12 on the CPU: files Pillow writes at test time (qualities
50, 75 and 95; 4:4:4, 4:2:2 and 4:2:0; greyscale; optimised Huffman
tables; restart markers; odd sizes from 1 x 1; noise), files
chip_smoke.py's numpy encoder writes (4:4:0 too, which Pillow cannot
write), and blocks whose coefficients push the IDCT past its output range.
The native decoder and the plain one (`decode_jpeg_plain`) must both give
`np.asarray(Image.open(p).convert("RGB"))` byte for byte; the forms the
decoder refuses raise ValueError.
"""
import io

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from paddle3d_tpu_torch.utils import image, jpeg

SIZES = [(1, 1), (2, 3), (9, 17), (37, 53), (48, 64)]


def pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def content(rng, h, w, kind):
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 7 % 256], -1)
    return (base + rng.integers(-20, 21, base.shape)).clip(0, 255).astype(
        np.uint8)


def pillow_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_decodes_as_pillow(data: bytes):
    want = pillow_rgb(data)
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jpeg.decode_jpeg_plain(data), want)
    hdr = jpeg.jpeg_header(data)
    assert (hdr["height"], hdr["width"]) == want.shape[:2]


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_matches_pillow_by_quality_and_subsampling(quality, subsampling):
    """4:4:4, 4:2:2 and 4:2:0 at qualities 50, 75, 95, at sizes from 1 x 1
    that are not whole MCUs, smooth and noise content."""
    rng = np.random.default_rng(quality + subsampling)
    for h, w in SIZES:
        for kind in ("smooth", "noise"):
            assert_decodes_as_pillow(pillow_jpeg(
                content(rng, h, w, kind), quality=quality,
                subsampling=subsampling))


@pytest.mark.parametrize("case", ["grey", "optimize", "restart_blocks",
                                  "restart_rows", "noise_q100"])
def test_matches_pillow_on_greyscale_optimised_restarts(case):
    rng = np.random.default_rng(7)
    for h, w in SIZES[1:]:
        img = content(rng, h, w, "noise" if case == "noise_q100" else
                      "smooth")
        kw = {"quality": 80, "subsampling": 2}
        if case == "grey":
            img, kw = np.asarray(Image.fromarray(img).convert("L")), {
                "quality": 80}
        elif case == "optimize":
            kw["optimize"] = True
        elif case == "restart_blocks":
            kw["restart_marker_blocks"] = 1
        elif case == "restart_rows":
            kw["restart_marker_rows"] = 1
        else:
            kw = {"quality": 100, "subsampling": 0}
        assert_decodes_as_pillow(pillow_jpeg(img, **kw))


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0",
                                      "grey"])
def test_chip_smoke_encoder_decodes_as_pillow(sampling):
    """chip_smoke.jpeg_bytes (the card's tree writer: numpy alone) gives
    files both decoders read as Pillow does, 4:4:0 included; with restart
    markers every MCU and every three."""
    rng = np.random.default_rng(11)
    for h, w in [(1, 1), (9, 17), (37, 53)]:
        img = content(rng, h, w, "noise")
        if sampling == "grey":
            img, sampling_ = img[..., 0], "4:4:4"
        else:
            sampling_ = sampling
        for restart in (0, 1, 3):
            data = chip_smoke.jpeg_bytes(img, 75, sampling_, restart)
            assert_decodes_as_pillow(data)
            assert jpeg.jpeg_header(data)["components"][0]["h"] == (
                chip_smoke.JPEG_SAMPLING[sampling_][0]
                if img.ndim == 3 else 1)


def _idct_c_form(coef, quant):
    """jidctint.c's C form (int64 arithmetic, the range-limit table that
    wraps mod 1024) on [N, 64] blocks -> [N, 8, 8] uint8."""
    limit = np.concatenate([np.arange(128, 256), np.full(384, 255),
                            np.zeros(384), np.arange(0, 128)]).astype(
                                np.uint8)
    c = (coef.astype(np.int64) * quant).reshape(-1, 8, 8)

    def one(x, shift):
        z1 = (x[2] + x[6]) * 4433
        t2, t3 = z1 + x[6] * -15137, z1 + x[2] * 6270
        t0, t1 = (x[0] + x[4]) * 8192, (x[0] - x[4]) * 8192
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        a, b, cc, d = x[7], x[5], x[3], x[1]
        z5 = (a + cc + b + d) * 9633
        z3, z4 = (a + cc) * -16069 + z5, (b + d) * -3196 + z5
        z1, z2 = (a + d) * -7373, (b + cc) * -20995
        a, b = a * 2446 + z1 + z3, b * 16819 + z2 + z4
        cc, d = cc * 25172 + z2 + z3, d * 12299 + z1 + z4
        r = 1 << (shift - 1)
        return [(v + r) >> shift for v in (t10 + d, t11 + cc, t12 + b,
                                           t13 + a, t13 - a, t12 - b,
                                           t11 - cc, t10 - d)]
    ws = np.stack(one([c[:, r, :] for r in range(8)], 11), axis=1)
    out = np.stack(one([ws[:, :, k] for k in range(8)], 18), axis=2)
    return limit[out & 1023]


@pytest.mark.parametrize("amp,quality", [(0, 50), (60, 50), (1023, 95),
                                         (1023, 1)])
def test_out_of_range_blocks_follow_pillow_not_the_c_range_limit(
        amp, quality):
    """Crafted greyscale blocks (AC up to +-amp, DC differences summing far
    past 16 bits, every other block with coefficient rows 1-7 zero) push
    the IDCT past its output range. Pillow's libjpeg-turbo runs its x86-64
    SIMD islow there: 16-bit dequantisation and sums, saturation where
    jidctint.c's C form wraps through its range-limit table. Both
    decoders give Pillow's bytes; the C form gives other bytes."""
    rng = np.random.default_rng(amp + quality)
    coefs = rng.integers(-amp, amp + 1, (8, 8, 64))
    coefs[::2, :, 8:] = 0
    coefs[..., 0] = np.cumsum(rng.integers(-2000, 2001, 64)).reshape(8, 8)
    tables = chip_smoke.jpeg_tables(quality)
    data = chip_smoke.jpeg_encode([coefs], tables, (1, 1), 64, 64)
    want = pillow_rgb(data)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg_plain(data), want)
    wrapped = (((coefs.reshape(-1, 64) + 32768) & 0xFFFF) - 32768)
    c_form = _idct_c_form(wrapped, tables[0]).reshape(8, 8, 8, 8).transpose(
        0, 2, 1, 3).reshape(64, 64)
    assert not np.array_equal(c_form, want[..., 0])


def _with_sof(data: bytes, marker=None, precision=None):
    """data with its SOF's marker byte or precision changed."""
    b = bytearray(data)
    i = next(i for i in range(2, len(b) - 1) if b[i] == 0xFF and
             0xC0 <= b[i + 1] <= 0xC2)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


def test_refused_forms_raise(tmp_path):
    rng = np.random.default_rng(3)
    img = content(rng, 16, 16, "smooth")
    base = pillow_jpeg(img, quality=80)
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    cases = {
        "progressive": pillow_jpeg(img, quality=80, progressive=True),
        "CMYK": cmyk.getvalue(),
        "arithmetic": _with_sof(base, marker=0xC9),
        "lossless": _with_sof(base, marker=0xC3),
        "12-bit": _with_sof(base, precision=12),
        "not a JPEG": b"\x89PNG\r\n\x1a\n" + base[8:],
    }
    for what, data in cases.items():
        for fn in (jpeg.decode_jpeg, jpeg.decode_jpeg_plain,
                   jpeg.jpeg_header):
            with pytest.raises(ValueError, match=what if what != "12-bit"
                               else "precision"):
                fn(data)
    p = tmp_path / "p.jpg"
    p.write_bytes(cases["progressive"])
    with pytest.raises(ValueError, match=str(p)):
        jpeg.read_jpeg(p)
    assert jpeg.jpeg_size(tmp_path / "missing.jpg") is None


def test_read_image_picks_the_decoder_by_signature(tmp_path):
    """read_image reads a JPEG named .png and a PNG named .jpg as
    Image.open does (by their first bytes); jpeg_size comes from the frame
    header."""
    rng = np.random.default_rng(5)
    img = content(rng, 23, 41, "smooth")
    j, p = tmp_path / "a.png", tmp_path / "b.jpg"
    j.write_bytes(pillow_jpeg(img, quality=90))
    Image.fromarray(img).save(p, "PNG")
    np.testing.assert_array_equal(image.read_image(j), pillow_rgb(
        j.read_bytes()))
    np.testing.assert_array_equal(image.read_image(p), img)
    assert jpeg.jpeg_size(j) == (23, 41)
    (tmp_path / "c.jpg").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image.read_image(tmp_path / "c.jpg")
