"""The port's JPEG codec (``xlstm_yolo_torch/native/jpeg.cpp``) against
OpenCV's libjpeg-turbo, bit for bit.

* The encoder against ``cv2.imencode(".jpg")`` byte for byte: RGB and gray,
  qualities 50, 75, 95 (cv2's default) and 100, sizes 1 x 1, 7 x 13, 17 x 33
  and 641 x 479; ``imwrite`` against ``cv2.imwrite``.
* The decoder against ``cv2.imread(..., IMREAD_COLOR)[..., ::-1]`` exactly:
  those files, every sampling cv2 writes (4:1:1, 4:2:2, 4:2:0, 4:4:0,
  4:4:4) as baseline, progressive and with restart intervals, gray, a
  Pillow file with optimized Huffman tables (and a progressive one), the
  EXIF orientations 1-8 spliced into an APP1, truncated files, and
  progressive files cut at every scan and every 7th byte (libjpeg's block
  smoothing of the missing AC terms, and the SIMD IDCT's 16-bit lanes on
  the garbage a cut leaves).
* The refused frames (arithmetic, 12-bit, lossless, CMYK) raise a
  ``ValueError`` that names the case.
"""
from __future__ import annotations

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from xlstm_yolo_torch import native
from xlstm_yolo_torch.data import imgproc as ip

SIZES = [(1, 1), (7, 13), (17, 33), (641, 479)]
SAMPLINGS = {"411": 0x411111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
             "444": 0x111111}


def _image(h, w, seed=0):
    """Gradients plus seeded noise: every DCT band and the clamps are hit."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 3 + y) % 256, (y * 5 + 40) % 256, ((x + y) * 2) % 256], -1)
    img = img.astype(np.float64) + rng.normal(0, 24, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_decode(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _cv2_encode(img: np.ndarray, *params) -> bytes:
    bgr = img if img.ndim == 2 else img[..., ::-1]
    ok, buf = cv2.imencode(".jpg", bgr, list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_and_decode_equal_cv2(size, quality):
    img = _image(*size, seed=size[0] + quality)
    want = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality)
    got = native.jpeg_encode(img, quality)
    assert got == want
    np.testing.assert_array_equal(native.jpeg_decode(want), _cv2_decode(want))
    gray = img[..., 1]
    want = _cv2_encode(gray, cv2.IMWRITE_JPEG_QUALITY, quality)
    assert native.jpeg_encode(gray, quality) == want
    np.testing.assert_array_equal(native.jpeg_decode(want), _cv2_decode(want))


def test_default_quality_and_imwrite_equal_cv2(tmp_path):
    img = _image(48, 64, seed=3)
    assert native.jpeg_encode(img) == _cv2_encode(img)
    ip.imwrite(tmp_path / "a.jpg", img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img[..., ::-1])
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    ip.imwrite(tmp_path / "c.jpeg", img, quality=60)
    cv2.imwrite(str(tmp_path / "d.jpeg"), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 60])
    assert (tmp_path / "c.jpeg").read_bytes() == (tmp_path / "d.jpeg").read_bytes()
    np.testing.assert_array_equal(ip.imread(tmp_path / "c.jpeg"),
                                  cv2.imread(str(tmp_path / "c.jpeg"))[..., ::-1])


@pytest.mark.parametrize("mode", ["baseline", "progressive", "restart"])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_decode_every_sampling(sampling, mode):
    extra = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
             "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}[mode]
    for size in [(7, 13), (17, 33), (2, 3), (97, 161)]:
        img = _image(*size, seed=size[1])
        data = _cv2_encode(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling],
                           cv2.IMWRITE_JPEG_QUALITY, 90, *extra)
        np.testing.assert_array_equal(native.jpeg_decode(data), _cv2_decode(data),
                                      err_msg=f"{size}")


@pytest.mark.parametrize("mode", ["progressive", "restart", "optimize"])
def test_decode_gray_modes(mode):
    flag = {"progressive": cv2.IMWRITE_JPEG_PROGRESSIVE, "restart": cv2.IMWRITE_JPEG_RST_INTERVAL,
            "optimize": cv2.IMWRITE_JPEG_OPTIMIZE}[mode]
    gray = _image(33, 47, seed=5)[..., 2]
    data = _cv2_encode(gray, flag, 1)
    np.testing.assert_array_equal(native.jpeg_decode(data), _cv2_decode(data))


@pytest.mark.parametrize("kw", [{"optimize": True}, {"progressive": True, "optimize": True},
                                {"quality": 30, "subsampling": 1}])
def test_decode_pillow_files(kw):
    buf = io.BytesIO()
    Image.fromarray(_image(71, 89, seed=9)).save(buf, "JPEG", **kw)
    data = buf.getvalue()
    np.testing.assert_array_equal(native.jpeg_decode(data), _cv2_decode(data))


def _with_orientation(data: bytes, orientation: int, order: str = "<") -> bytes:
    """The JPEG with an EXIF APP1 (IFD0: Orientation) spliced after SOI."""
    mark = b"II" if order == "<" else b"MM"
    tiff = mark + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
    tiff += struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(order + "I", 0)
    body = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation):
    data = _cv2_encode(_image(21, 34, seed=orientation))
    for order in "<>":
        p = tmp_path / f"o{orientation}{order == '<'}.jpg"
        p.write_bytes(_with_orientation(data, orientation, order))
        want = cv2.imread(str(p), cv2.IMREAD_COLOR)[..., ::-1]
        got = ip.imread(p)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert ip.image_shape(p) == (21, 34)  # the header's size, as the JAX package reads it


@pytest.mark.parametrize("mode", ["baseline", "restart"])
def test_truncated_file(tmp_path, mode):
    extra = [] if mode == "baseline" else [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
    data = _cv2_encode(_image(64, 80, seed=11), *extra)
    for cut in (len(data) * 2 // 3, len(data) // 3 + 7):
        p = tmp_path / f"t{cut}.jpg"
        p.write_bytes(data[:cut])
        want = cv2.imread(str(p), cv2.IMREAD_COLOR)
        assert want is not None
        np.testing.assert_array_equal(ip.imread(p), want[..., ::-1])


def test_truncated_progressive_within_smoothing_bound(tmp_path):
    """A progressive file cut short decodes as libjpeg decodes it: the
    blocks whose AC bits never came smoothed from their neighbours' DC
    (``decompress_smooth_data``), with each iMCU row's smoothing set by the
    scans that reached it; the complete file too."""
    data = _cv2_encode(_image(64, 80, seed=11), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    np.testing.assert_array_equal(native.jpeg_decode(data), _cv2_decode(data))
    for cut in (len(data) * 2 // 3, len(data) // 2, len(data) // 3 + 7):
        p = tmp_path / f"t{cut}.jpg"
        p.write_bytes(data[:cut])
        np.testing.assert_array_equal(ip.imread(p), cv2.imread(str(p))[..., ::-1])


def _scan_starts(data: bytes) -> list:
    return [i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


@pytest.mark.parametrize("case", ["420", "444", "gray", "422_restart"])
def test_truncated_progressive_exact(case):
    """Progressive files at quality 30 cut at every scan (EOI appended: the
    DC-only image takes libjpeg's 5 x 5 DC interpolation) and every 7th
    byte of the scans, with and without an EOI after the cut. Cuts inside
    a scan leave garbage coefficients in the MCU where the data ends; their
    pixels equal libjpeg-turbo's SIMD IDCT (16-bit lanes that wrap and
    saturate) as OpenCV runs it."""
    img, params = {"420": (_image(64, 80, seed=11), []),
                   "444": (_image(40, 56, seed=3),
                           [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS["444"]]),
                   "gray": (_image(48, 40, seed=5)[..., 0], []),
                   "422_restart": (_image(37, 45, seed=2),
                                   [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS["422"],
                                    cv2.IMWRITE_JPEG_RST_INTERVAL, 2])}[case]
    data = _cv2_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 30,
                       *params)
    starts = _scan_starts(data)
    cuts = [(c, b"\xff\xd9") for c in starts[1:]] + [
        (c, tail) for c in range(starts[0] + 12, len(data), 7) for tail in (b"", b"\xff\xd9")]
    checked = 0
    for c, tail in cuts:
        cut = data[:c] + tail
        want = cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR)
        if want is None:  # cut inside a header: OpenCV refuses the file
            continue
        np.testing.assert_array_equal(native.jpeg_decode(cut), want[..., ::-1], err_msg=str(c))
        checked += 1
    assert checked >= 40


def _patched(data: bytes, marker: int, precision: int | None = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("case,word", [("arithmetic", "arithmetic"), ("12-bit", "12-bit"),
                                       ("lossless", "lossless"), ("cmyk", "CMYK")])
def test_refused_frames(tmp_path, case, word):
    data = _cv2_encode(_image(16, 16))
    if case == "arithmetic":
        data = _patched(data, 0xC9)
    elif case == "12-bit":
        data = _patched(data, 0xC1, precision=12)
    elif case == "lossless":
        data = _patched(data, 0xC3)
    else:
        buf = io.BytesIO()
        Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(buf, "JPEG")
        data = buf.getvalue()
    with pytest.raises(ValueError, match=word):
        native.jpeg_decode(data)
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    with pytest.raises(ValueError, match=word):
        ip.imread(p)
