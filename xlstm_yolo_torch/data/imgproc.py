"""The image operations of the data path, in numpy: the port's stand-in for
the ``cv2`` calls of ``xlstm_yolo_tpu/data/`` (the card's machine has
neither OpenCV nor Pillow).

* ``imread`` / ``imwrite``: PNG (8-bit gray, gray+alpha, RGB, RGBA, palette;
  not interlaced) and BMP (8-bit palette, 24- and 32-bit, uncompressed) are
  decoded and encoded here, with the standard library's ``zlib``. JPEG goes
  through the native codec (``native/jpeg.cpp``): decoded as
  ``cv2.imread(..., IMREAD_COLOR)`` decodes it, EXIF orientation applied,
  and written as ``cv2.imwrite`` writes it (quality 95 by default). Only
  where no g++ exists, and for the other formats of ``IMG_FORMATS``,
  ``imread`` goes through ``cv2`` or Pillow, imported inside it; where
  neither is installed it raises an error that names the format and the
  packages. ``image_shape`` reads
  (h, w) from a PNG, BMP or JPEG header without decoding. Images are RGB uint8
  (H, W, 3), as ``cv2.imread`` then ``COLOR_BGR2RGB`` gives them: alpha is
  dropped, gray is repeated.
* ``resize``: ``cv2.resize(..., INTER_LINEAR)`` on uint8, half-pixel centres,
  in cv2's fixed point (11-bit weights per axis, the rounding of its
  vectorized vertical pass; an exact 2x reduction is cv2's 2x2 mean).
* ``warp_affine`` / ``warp_perspective``: ``cv2.warpAffine`` /
  ``cv2.warpPerspective`` (bilinear, constant border) as OpenCV 5 computes
  them: fp32 source positions, fused lerps of the four taps, rounded to
  the nearest level (``warp_affine`` exactly, its positions fused
  multiply-adds too).
* ``rgb2hsv`` / ``hsv2rgb``: ``cv2.cvtColor`` ``COLOR_RGB2HSV`` /
  ``COLOR_HSV2RGB`` on uint8 (hue on cv2's 0-179 scale), with cv2's integer
  tables one way and its fp32 sector formula (truncated in its vectorized
  loop, rounded in its scalar one) the other; ``lut`` is ``cv2.LUT``.
* ``rgb2gray``, ``gaussian_blur3``, ``equalize_hist``,
  ``rotation_matrix_2d``: ``cv2.cvtColor(COLOR_RGB2GRAY)``,
  ``cv2.GaussianBlur(img, (3, 3), 0)``, ``cv2.equalizeHist`` and
  ``cv2.getRotationMatrix2D``, the ops of the classify transforms, exact.
* ``fill_rect``, ``fill_circle``, ``fill_poly``: the shape fills of the
  synthetic dataset writer (pixel centres inside the shape; not cv2's
  rasterizer, which nothing compares against).

``tests/test_torch_data.py`` holds each op against ``cv2`` with the
tolerance it states.
"""
from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

IMG_FORMATS = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
BORDER = 114  # the letterbox and warp fill of the data path

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


# ---------------------------------------------------------------------------
# decode / encode
# ---------------------------------------------------------------------------

def _to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) gray / gray+alpha / RGB / RGBA -> (H, W, 3) RGB."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, axis=2))
    return np.ascontiguousarray(img[..., :3])


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:  # Up
            cur = (line + prev) & 255
        elif ftype in (3, 4):  # Average, Paeth: a recurrence along the row
            cur = [0] * stride
            lin, pr = line.tolist(), prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                c = pr[i - bpp] if i >= bpp else 0
                pred = (a + pr[i]) >> 1 if ftype == 3 else _paeth(a, pr[i], c)
                cur[i] = (lin[i] + pred) & 255
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def _png_decode(data: bytes, path) -> np.ndarray:
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}; the port reads 8-bit non-interlaced gray, gray+alpha, "
                         f"RGB, RGBA and palette PNGs")
    ch = _PNG_CHANNELS[ctype]
    img = _png_unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[img[..., 0]]
    return _to_rgb(img)


def _png_encode(img: np.ndarray) -> bytes:
    """RGB (H, W, 3) or gray (H, W) uint8 -> PNG bytes (filter None on every
    row)."""
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _bmp_decode(data: bytes, path) -> np.ndarray:
    off = struct.unpack("<I", data[10:14])[0]
    hsize, w, h, _, bits, comp = struct.unpack("<IiiHHI", data[14:34])
    if comp not in (0, 3) or bits not in (8, 24, 32) or (comp == 3 and bits != 32):
        raise ValueError(f"{path}: BMP of {bits} bits, compression {comp}; the port reads "
                         f"uncompressed 8-bit palette, 24- and 32-bit BMPs")
    top_down, h = h < 0, abs(h)
    stride = (w * bits // 8 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=off).reshape(h, stride)
    if bits == 8:
        ncol = struct.unpack("<I", data[46:50])[0] or 256
        pal = np.frombuffer(data, np.uint8, count=4 * ncol, offset=14 + hsize).reshape(-1, 4)
        img = pal[rows[:, :w]][..., 2::-1]
    else:
        img = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[..., 2::-1]  # BGR(A) -> RGB
    return np.ascontiguousarray(img if top_down else img[::-1])


def _bmp_encode(img: np.ndarray) -> bytes:
    rgb = _to_rgb(img)
    h, w = rgb.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, -1)  # bottom-up BGR
    body = rows.tobytes()
    return (b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 2835, 2835, 0, 0)
            + body)


def _tiff_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of a TIFF header's first IFD, 1 where
    there is none or it is out of 1-8."""
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or len(tiff) < 8:
        return 1
    ifd = struct.unpack(order + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    count = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, typ = struct.unpack(order + "HH", entry[:4])
        if tag == 0x0112 and typ == 3:
            value = struct.unpack(order + "H", entry[8:10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def exif_orientation(data: bytes) -> int:
    """A JPEG stream's EXIF orientation (1-8) from its first ``Exif`` APP1
    segment before the first scan; 1 without one."""
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            return 1
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        if m in (0xD9, 0xDA):
            return 1
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + length]
        if m == 0xE1 and seg[:6] == b"Exif\0\0":
            return _tiff_orientation(seg[6:])
        pos += 2 + length
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn a decoded image upright by its EXIF orientation, as OpenCV's
    ``IMREAD_COLOR`` does (flips, then for 5-8 a transpose first)."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flip:
        img = np.flip(img, flip)
    return np.ascontiguousarray(img)


def _jpeg_read(data: bytes) -> np.ndarray:
    from .. import native

    return apply_orientation(native.jpeg_decode(data), exif_orientation(data))


def imread(path: str | Path) -> np.ndarray:
    """Read an image file as RGB uint8 (H, W, 3). PNG, BMP and (with g++)
    JPEG are decoded here; the other formats through ``cv2`` (as the JAX
    package reads them) or else Pillow, imported here; neither installed
    raises."""
    from .. import native

    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"cannot read image {p}")
    data = p.read_bytes()
    if data[:8] == _PNG_SIG:
        return _png_decode(data, p)
    if data[:2] == b"BM":
        return _bmp_decode(data, p)
    if data[:2] == b"\xff\xd8" and native.available():
        try:
            return _jpeg_read(data)
        except ValueError as e:
            raise ValueError(f"cannot read image {p}: {e}") from None
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(p), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image {p}")
        return np.ascontiguousarray(img[..., ::-1])
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"reading {p.suffix or 'this'} images ({p}) needs OpenCV (cv2) or Pillow, and "
            f"neither is installed; the port decodes .png and .bmp itself, and JPEG where "
            f"g++ is on PATH") from None
    with Image.open(p) as im:
        return np.asarray(im.convert("RGB"))


# JPEG start-of-frame markers (SOF0-15 but DHT, JPG and DAC), which carry the size
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def _jpeg_shape(f) -> tuple[int, int] | None:
    """(h, w) from the first SOFn segment of a JPEG stream past its SOI."""
    while True:
        b = f.read(1)
        if not b:
            return None
        if b != b"\xff":
            continue
        marker = f.read(1)
        while marker == b"\xff":  # fill bytes
            marker = f.read(1)
        if not marker:
            return None
        m = marker[0]
        if m == 0xD8 or m == 0x01 or 0xD0 <= m <= 0xD7:  # no length field
            continue
        if m in (0xD9, 0xDA):  # end of image, or the scan before any frame header
            return None
        seg = f.read(2)
        if len(seg) < 2:
            return None
        n = struct.unpack(">H", seg)[0]
        if m in _JPEG_SOF:
            body = f.read(5)
            if len(body) < 5:
                return None
            h, w = struct.unpack(">HH", body[1:5])
            return h, w
        f.seek(n - 2, 1)


def image_shape(path: str | Path) -> tuple[int, int]:
    """An image file's (h, w) from its header, without decoding it: PNG
    IHDR, BMP info header, JPEG SOFn. Other formats are decoded
    (``imread``). Raises ValueError on a header it cannot read."""
    p = Path(path)
    with open(p, "rb") as f:
        head = f.read(26)
        if head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return int(h), int(w)
        if head[:2] == b"BM" and len(head) >= 26:
            if struct.unpack("<I", head[14:18])[0] == 12:  # BITMAPCOREHEADER
                w, h = struct.unpack("<HH", head[18:22])
            else:
                w, h = struct.unpack("<ii", head[18:26])
            return abs(int(h)), abs(int(w))
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            shape = _jpeg_shape(f)
            if shape is None:
                raise ValueError(f"no JPEG frame header in {p}")
            return shape
    if head[:8] == _PNG_SIG or head[:2] == b"BM":
        raise ValueError(f"truncated image header in {p}")
    return imread(p).shape[:2]


def imwrite(path: str | Path, img: np.ndarray, quality: int = 95) -> Path:
    """Write RGB (H, W, 3) or gray (H, W) uint8 as ``.png``, ``.bmp`` or
    ``.jpg`` / ``.jpeg`` (baseline, 4:2:0, ``quality`` as cv2's
    ``IMWRITE_JPEG_QUALITY``: the bytes ``cv2.imwrite`` writes)."""
    from .. import native

    p = Path(path)
    img = np.ascontiguousarray(img, np.uint8)
    suffix = p.suffix.lower()
    if suffix == ".png":
        p.write_bytes(_png_encode(img))
    elif suffix == ".bmp":
        p.write_bytes(_bmp_encode(img))
    elif suffix in (".jpg", ".jpeg"):
        p.write_bytes(native.jpeg_encode(img, quality))
    else:
        raise ValueError(f"the port writes .png, .bmp, .jpg and .jpeg, not {p.suffix!r}")
    return p


# ---------------------------------------------------------------------------
# resize (cv2 INTER_LINEAR on uint8)
# ---------------------------------------------------------------------------

def _linear_taps(n_in: int, n_out: int, clamp_weights: bool = True):
    """Per output index: the two source indices and their 11-bit weights,
    as cv2 computes them (fp32 positions, half-pixel centres). Past an edge
    the indices clamp; along x (``clamp_weights``) the weights become (1,
    0) there too, while along y cv2 keeps the weights and blends the
    clamped row with itself."""
    scale = 1.0 / (n_out / n_in)
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    if clamp_weights:
        fx[(sx < 0) | (sx >= n_in - 1)] = 0.0
        sx = np.where(sx < 0, 0, np.minimum(sx, n_in - 1))
    a1 = np.rint(fx * np.float32(2048)).astype(np.int64)
    a0 = np.rint((np.float32(1) - fx) * np.float32(2048)).astype(np.int64)
    return np.clip(sx, 0, n_in - 1), np.clip(sx + 1, 0, n_in - 1), a0, a1


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for uint8
    (H, W, C); ``size`` is (width, height) as cv2 takes it."""
    w_out, h_out = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (h_out, w_out) == (h, w):
        return img.copy()
    if (h, w) == (2 * h_out, 2 * w_out):  # cv2 takes its 2x2 mean here
        s = img.reshape(h_out, 2, w_out, 2, -1).astype(np.int32).sum(axis=(1, 3))
        return ((s + 2) >> 2).astype(np.uint8).reshape(h_out, w_out, *img.shape[2:])
    x0, x1, a0, a1 = _linear_taps(w, w_out)
    y0, y1, b0, b1 = _linear_taps(h, h_out, clamp_weights=False)
    src = img.astype(np.int64).reshape(h, w, -1)
    hor = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # (H, w_out, C)
    # the vertical pass of cv2's vectorized loop: each row sum >> 4, a high
    # half product with the 11-bit weight, then a rounding shift by 2
    r0, r1 = hor[y0] >> 4, hor[y1] >> 4
    v = ((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8).reshape(h_out, w_out, *img.shape[2:])


def _linear_taps_f32(n_in: int, n_out: int):
    """cv2's float INTER_LINEAR taps: the source position (i + 0.5) * scale
    - 0.5 in fp64 with scale = 1 / (n_out / n_in), its floor, and the
    fraction rounded to fp32 once; past an edge the index clamps and the
    fraction is 0."""
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float32)
    frac[s < 0], s[s < 0] = 0.0, 0
    edge = s >= n_in - 1
    frac[edge], s[edge] = 0.0, n_in - 1
    return s, np.minimum(s + 1, n_in - 1), frac


def resize_linear_f32(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for float32
    (H, W) or (H, W, C), bit for bit with OpenCV 5: each pass is a fused
    ``fma(b - a, frac, a)`` between the two taps (``_linear_taps_f32``),
    horizontal then vertical. An exact 2x shrink takes the same taps (0.5
    each): OpenCV 5 keeps INTER_LINEAR there for float maps (its uint8 path
    takes the 2 x 2 area mean, ``resize``). ``size`` is (width, height)."""
    img = np.asarray(img, np.float32)
    x0, x1, fx = _linear_taps_f32(img.shape[1], int(size[0]))
    y0, y1, fy = _linear_taps_f32(img.shape[0], int(size[1]))
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    left = img[:, x0]
    rows = _fma(img[:, x1] - left, fx[ex], left)
    top = rows[y0]
    return _fma(rows[y1] - top, fy[(slice(None), None) + ex[1:]], top)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``: source
    index floor(i * in / out); ``size`` is (width, height)."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(size[1]) * (h / size[1])).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(size[0]) * (w / size[0])).astype(np.int64), w - 1)
    return img[ys][:, xs]


# ---------------------------------------------------------------------------
# warps (cv2 warpAffine / warpPerspective, bilinear, constant border)
# ---------------------------------------------------------------------------

def _fma(a, b, c) -> np.ndarray:
    """fp32 ``a * b + c`` rounded once (a fused multiply-add): the fp32
    product is exact in fp64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _remap(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    """Bilinear sample of uint8 ``img`` at the fp32 source positions (sx,
    sy) (arrays of the output's shape), taps outside the image reading
    ``border``, blended as OpenCV 5's warps blend them (two fused lerps
    along x, then one along y) and rounded to the nearest level."""
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    c = src.shape[2]
    pad = np.full((h + 2, w + 2, c), border, np.uint8)
    pad[1:-1, 1:-1] = src
    flat = pad.reshape(-1, c)
    lim = np.float32(2 ** 30)
    sx, sy = np.clip(sx, -lim, lim), np.clip(sy, -lim, lim)
    fx0, fy0 = np.floor(sx), np.floor(sy)
    ax, ay = sx - fx0, sy - fy0
    ix, iy = fx0.astype(np.int64), fy0.astype(np.int64)
    # a tap outside the image reads the padding ring (its index clamped there)
    cx0, cx1 = np.clip(ix + 1, 0, w + 1), np.clip(ix + 2, 0, w + 1)
    cy0, cy1 = np.clip(iy + 1, 0, h + 1), np.clip(iy + 2, 0, h + 1)
    tap = lambda yy, xx: flat[yy * (w + 2) + xx].astype(np.float32)
    a, b = ax[..., None], ay[..., None]
    top, bot = tap(cy0, cx0), tap(cy1, cx0)
    top = _fma(a, tap(cy0, cx1) - top, top)
    bot = _fma(a, tap(cy1, cx1) - bot, bot)
    acc = _fma(b, bot - top, top)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8).reshape(*sx.shape, *img.shape[2:])


def _grid(size: tuple[int, int]):
    w_out, h_out = int(size[0]), int(size[1])
    ys, xs = np.mgrid[:h_out, :w_out]
    return xs.astype(np.float32), ys.astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, size: tuple[int, int],
                border: int = BORDER) -> np.ndarray:
    """``cv2.warpAffine(img, M, size, borderValue=(border,) * 3)`` for uint8,
    exactly as OpenCV 5 computes it: ``M`` (2, 3) maps source to
    destination, inverted in fp64 and cast to fp32; each row's first
    multiple of WARP_BLOCK pixels (its vectorized loop) take their source
    position as a fused multiply-add of x onto the row's fp32 offset, the
    rest (its scalar loop) as fma(x, m0, y m1) + m2; then ``_remap``'s
    lerps. ``size`` is (width, height)."""
    m = np.asarray(M, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a = np.array([[m[1, 1] * d, -m[0, 1] * d, 0.0], [-m[1, 0] * d, m[0, 0] * d, 0.0]])
    a[0, 2] = -a[0, 0] * m[0, 2] - a[0, 1] * m[1, 2]
    a[1, 2] = -a[1, 0] * m[0, 2] - a[1, 1] * m[1, 2]
    a = a.astype(np.float32)
    xs, ys = _grid(size)
    vec = xs < xs.shape[1] // WARP_BLOCK * WARP_BLOCK
    src = [np.where(vec, _fma(r[0], xs, r[1] * ys + r[2]), _fma(xs, r[0], ys * r[1]) + r[2])
           for r in a]
    return _remap(img, *src, border)


WARP_BLOCK = 16  # pixels a step of OpenCV 5's vectorized warpAffine loop takes (AVX2 build)


def warp_perspective(img: np.ndarray, M: np.ndarray, size: tuple[int, int],
                     border: int = BORDER) -> np.ndarray:
    """``cv2.warpPerspective(img, M, size, borderValue=(border,) * 3)`` for
    uint8: ``M`` (3, 3) maps source to destination."""
    a = np.linalg.inv(np.asarray(M, np.float64)).astype(np.float32)
    xs, ys = _grid(size)
    den = a[2, 0] * xs + a[2, 1] * ys + a[2, 2]
    den = np.where(den != 0, np.float32(1) / np.where(den != 0, den, np.float32(1)), np.float32(0))
    return _remap(img, (a[0, 0] * xs + a[0, 1] * ys + a[0, 2]) * den,
                  (a[1, 0] * xs + a[1, 1] * ys + a[1, 2]) * den, border)


# ---------------------------------------------------------------------------
# colour (cv2 COLOR_RGB2HSV / COLOR_HSV2RGB on uint8, hue 0-179)
# ---------------------------------------------------------------------------

def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << 12) / i), 0).astype(np.int32)
        hdiv = np.where(i > 0, np.rint((180 << 12) / (6.0 * i)), 0).astype(np.int32)
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` for uint8 RGB (..., 3)."""
    x = img.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


HSV_BLOCK = 32  # pixels a step of cv2's vectorized HSV -> RGB loop takes (AVX2 build)


def _one_minus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """fp32 ``1 - a * b`` rounded once, as the fused multiply-subtract cv2's
    build computes it: the fp32 product is exact in fp64, and over the
    uint8 HSV domain the fp64 difference rounds to the fp32 the fused
    operation gives (checked on every HSV triple)."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def hsv2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` for uint8 HSV (H, W, 3) (or
    any (..., W, 3)), exactly: cv2's fp32 sector formula with its fused
    ``1 - s h`` terms; each row's first multiple of HSV_BLOCK pixels go
    through its vectorized loop, which truncates to a level, the rest of
    the row through its scalar loop, which rounds."""
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, f32(0), h)
    tab = np.stack([v, v * (f32(1) - s), v * _one_minus(s, h), v * _one_minus(s, f32(1) - h)],
                   axis=-1)
    idx = _SECTORS[sector]  # (..., 3) = which tab entry is b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    gray = (s == 0)[..., None]
    bgr = np.where(gray, v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255.0)
    width = img.shape[-2] if img.ndim >= 2 else 1
    vectorized = (np.arange(width) < width // HSV_BLOCK * HSV_BLOCK)[:, None]
    return np.clip(np.where(vectorized, np.trunc(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the classify transforms' ops (cv2 COLOR_RGB2GRAY, GaussianBlur 3x3,
# equalizeHist, getRotationMatrix2D)
# ---------------------------------------------------------------------------

def rgb2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for uint8 RGB (..., 3):
    OpenCV 5's 15-bit fixed point, (9798 R + 19235 G + 3735 B + 2^14) >>
    15 (equal to cv2 on every colour)."""
    x = img.astype(np.int32)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2] + (1 << 14)) >> 15
            ).astype(np.uint8)


def _reflect101(n: int) -> np.ndarray:
    """Source indices -1 .. n of an axis of length n under cv2's
    BORDER_REFLECT_101 (one pixel: itself)."""
    idx = np.arange(-1, n + 1)
    if n == 1:
        return np.zeros(3, np.int64)
    idx[0], idx[-1] = 1, n - 2
    return idx


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (3, 3), 0)`` for uint8 (H, W) or (H, W, C):
    the separable [1, 2, 1] / 4 kernel, summed exactly and rounded once,
    (sum + 8) >> 4, BORDER_REFLECT_101 at the edges."""
    x = img.astype(np.int32)
    h, w = x.shape[:2]
    p = x[_reflect101(h)][:, _reflect101(w)]
    row = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
    return ((row[:-2] + 2 * row[1:-1] + row[2:] + 8) >> 4).astype(np.uint8)


def equalize_hist(ch: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of one uint8 channel: from the first non-empty
    bin, the cumulative count times the fp32 255 / (total - that bin's
    count), rounded to the nearest level (half to even); an image of one
    value is returned as it is."""
    hist = np.bincount(ch.reshape(-1), minlength=256)
    first = int(np.argmax(hist > 0))
    if hist[first] == ch.size:
        return ch.copy()
    scale = np.float32(255.0) / np.float32(ch.size - hist[first])
    lut = np.rint((np.cumsum(hist) - hist[first]).astype(np.float32) * scale)
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    lut[:first + 1] = 0
    return lut[ch]


def rotation_matrix_2d(center: tuple, angle: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the (2, 3) fp64
    matrix of a rotation by ``angle`` degrees (counter-clockwise) about
    ``center`` (x, y)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``cv2.LUT``: ``table[img]`` for uint8 ``img`` and a 256-entry table."""
    return np.asarray(table)[img]


# ---------------------------------------------------------------------------
# shape fills (the synthetic dataset writer)
# ---------------------------------------------------------------------------

def fill_rect(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """Fill the pixels x1..x2, y1..y2 (both ends included) in place."""
    img[max(y1, 0):max(y2 + 1, 0), max(x1, 0):max(x2 + 1, 0)] = color


def fill_circle(img: np.ndarray, cx: float, cy: float, radius: float, color) -> None:
    """Fill the pixels whose centre lies within ``radius`` of (cx, cy)."""
    ys, xs = np.ogrid[:img.shape[0], :img.shape[1]]
    img[(xs - cx) ** 2 + (ys - cy) ** 2 <= radius ** 2] = color


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """Fill the pixels whose centre lies inside the polygon ``pts`` (n, 2) of
    (x, y) vertices (even-odd rule)."""
    pts = np.asarray(pts, np.float64)
    ys, xs = np.mgrid[:img.shape[0], :img.shape[1]].astype(np.float64)
    inside = np.zeros(img.shape[:2], bool)
    for (xa, ya), (xb, yb) in zip(pts, np.roll(pts, -1, axis=0)):
        if ya == yb:
            continue
        crosses = (ya > ys) != (yb > ys)
        xcross = xa + (ys - ya) * (xb - xa) / (yb - ya)
        inside ^= crosses & (xs < xcross)
    img[inside] = color


# ---------------------------------------------------------------------------
# cv2.fillPoly of one polygon with int32 vertices (the masks of the
# segment task), and cv2.minAreaRect / cv2.boxPoints (the OBB targets)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``cv2.clipLine`` of a segment to the (w, h) image: (inside, x1, y1,
    x2, y2), the coordinates moved as cv2 moves them (truncated)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """``cv2.line`` of width 1, 8-connected (Bresenham, drawn left to
    right, clipped to the image)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    if dy < 0:
        dy, sy = -dy, -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        diag = err < 0
        err += -2 * dy + (2 * dx if diag else 0)
        if steep:
            y, x = y + sy, x + diag
        else:
            x, y = x + 1, y + sy * diag
    return


def fill_poly_cv(img: np.ndarray, pts: np.ndarray, color) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], color)`` for one polygon of integer
    vertices, pixel for pixel (OpenCV 5's rules): every edge drawn as an
    8-connected line, then each row filled between pairs of edge
    crossings, x in 16.16 fixed point, the left end rounded up and the
    right end down. An edge that leaves the image runs along its clipped
    segment's line (a segment clipped to one row keeps its clipped x for
    every row). ``fill_poly`` is the other rule, pixel centres inside."""
    h, w = img.shape[:2]
    v = np.asarray(pts, np.int64).reshape(-1, 2)
    edges = []
    for i in range(len(v)):
        (ax, ay), (bx, by) = v[i - 1].tolist(), v[i].tolist()
        _line8(img, ax, ay, bx, by, color)
        c0x, c0y, c1x, c1y = ax << _XY_SHIFT, ay, bx << _XY_SHIFT, by
        if not (0 <= ax < w and 0 <= bx < w and 0 <= ay < h and 0 <= by < h):
            _, cax, cay, cbx, cby = _clip_line(w, h, ax, ay, bx, by)
            c0x, c1x = cax << _XY_SHIFT, cbx << _XY_SHIFT
            if cay != cby:
                c0y, c1y = cay, cby
        if ay == by:
            continue
        num, den = c1x - c0x, c1y - c0y
        dx = 0 if den == 0 else (abs(num) // abs(den)) * (1 if (num >= 0) == (den > 0) else -1)
        if ay < by:
            edges.append((ay, by, c0x + (ay - c0y) * dx, dx))
        else:
            edges.append((by, ay, c1x + (by - c1y) * dx, dx))
    if len(edges) < 2:
        return img
    ends = [x for y0, y1, x, dx in edges for x in (x, x + (y1 - y0) * dx)]
    if (max(e[1] for e in edges) < 0 or min(e[0] for e in edges) >= h or max(ends) < 0
            or min(ends) >= (w << _XY_SHIFT)):
        return img
    one = (1 << _XY_SHIFT) - 1
    for y in range(max(min(e[0] for e in edges), 0), min(max(e[1] for e in edges), h)):
        xs = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges if y0 <= y < y1)
        for k in range(0, len(xs) - 1, 2):
            x1, x2 = (xs[k] + one) >> _XY_SHIFT, xs[k + 1] >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
    return img


def _convex_hull_order(pts: np.ndarray) -> list:
    """The indices of ``cv2.convexHull(pts)`` (counter-clockwise), in its
    order: from the last point in (x, y) order, rotated to start at the
    least index where the indices run cyclically up (or the greatest where
    they run down)."""
    order = sorted(range(len(pts)), key=lambda i: (pts[i, 0], pts[i, 1]))
    p = pts.astype(np.float64)

    def cross(o, a, b):
        return (p[a, 0] - p[o, 0]) * (p[b, 1] - p[o, 1]) - (p[a, 1] - p[o, 1]) * (p[b, 0] - p[o, 0])

    lower, upper = [], []
    for chain, seq in ((lower, order), (upper, order[::-1])):
        for i in seq:
            while len(chain) >= 2 and cross(chain[-2], chain[-1], i) <= 0:
                chain.pop()
            chain.append(i)
    hull = lower[:-1] + upper[:-1] or order[:1]
    k = hull.index(order[-1]) if order[-1] in hull else 0
    hull = hull[k:] + hull[:k]
    n = len(hull)
    if n >= 3:
        rising = sum(hull[i] < hull[(i + 1) % n] for i in range(n))
        if rising in (1, n - 1):
            k = hull.index(min(hull) if rising == n - 1 else max(hull))
            hull = hull[k:] + hull[:k]
    return hull


def _calipers(pts: np.ndarray) -> np.ndarray:
    """OpenCV's rotating calipers for the least-area rectangle of a convex
    hull (n, 2) float32, in float32 as it computes them: (3, 2) = a corner,
    the width vector, the height vector."""
    f = np.float32
    n = len(pts)
    vect, inv_len = np.zeros((n, 2), f), np.zeros(n, f)
    ext = [0, 0, 0, 0]  # bottom (least y), right, top, left
    lo_x = hi_x = pts[0, 0]
    lo_y = hi_y = pts[0, 1]
    for i in range(n):
        x, y = pts[i]
        if x < lo_x:
            lo_x, ext[3] = x, i
        if x > hi_x:
            hi_x, ext[1] = x, i
        if y > hi_y:
            hi_y, ext[2] = y, i
        if y < lo_y:
            lo_y, ext[0] = y, i
        dx, dy = float(pts[(i + 1) % n, 0]) - float(x), float(pts[(i + 1) % n, 1]) - float(y)
        vect[i] = (dx, dy)
        inv_len[i] = 1.0 / math.sqrt(dx * dx + dy * dy)
    orientation = f(0)
    ax, ay = float(vect[-1, 0]), float(vect[-1, 1])
    for bx, by in vect.astype(np.float64):
        if ax * by - ay * bx != 0:
            orientation = f(1.0 if ax * by - ay * bx > 0 else -1.0)
            break
        ax, ay = bx, by
    base_a, base_b, seq = orientation, f(0), list(ext)
    minarea, best = f(np.finfo(f).max), None
    for _ in range(n):
        v = [vect[s] for s in seq]
        dp = [base_a * v[0][0] + base_b * v[0][1], -base_b * v[1][0] + base_a * v[1][1],
              -base_a * v[2][0] - base_b * v[2][1], base_b * v[3][0] - base_a * v[3][1]]
        main, maxcos = 0, dp[0] * inv_len[seq[0]]
        for i in range(1, 4):
            if dp[i] * inv_len[seq[i]] > maxcos:
                main, maxcos = i, dp[i] * inv_len[seq[i]]
        p = seq[main]
        lx, ly = vect[p, 0] * inv_len[p], vect[p, 1] * inv_len[p]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (seq[main] + 1) % n
        width = ((pts[seq[1], 0] - pts[seq[3], 0]) * base_a
                 + (pts[seq[1], 1] - pts[seq[3], 1]) * base_b)
        height = (-(pts[seq[2], 0] - pts[seq[0], 0]) * base_b
                  + (pts[seq[2], 1] - pts[seq[0], 1]) * base_a)
        if width * height <= minarea:
            minarea, best = width * height, (seq[3], base_a, width, base_b, height, seq[0])
    left, a1, width, b1, height, bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * pts[left, 0] + pts[left, 1] * b1
    c2 = a2 * pts[bottom, 0] + pts[bottom, 1] * b2
    idet = f(1.0) / (a1 * b2 - a2 * b1)
    return np.array([[(c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet],
                     [a1 * width, b1 * width], [a2 * height, b2 * height]], f)


def _rect_in_range(c, w, h, ang) -> tuple:
    """A rectangle's (centre, size, angle) with the angle moved into [-90, 0)
    by quarter turns, w and h swapped at each."""
    while ang >= 0:
        ang, w, h = ang - 90, h, w
    while ang < -90:
        ang, w, h = ang + 90, h, w
    f = np.float32
    return (float(f(c[0])), float(f(c[1]))), (float(f(w)), float(f(h))), float(f(ang))


def min_area_rect(points: np.ndarray) -> tuple:
    """``cv2.minAreaRect(points)``: ((cx, cy), (w, h), angle in degrees)
    with OpenCV 5's convention, the angle in [-90, 0) (an axis-aligned w x h
    box comes back as (h, w) at -90). OpenCV's rotating calipers run in
    float32 on the convex hull (``_convex_hull_order``, ``_calipers``), as
    cv2 runs them; their rectangle is checked against the least-area one
    with a side on a hull edge, found in float64, and that one is taken
    where the calipers' float32 rounding lost the minimum (some
    near-rectangles). Where two different rectangles' areas tie to float32
    rounding (a triangle, a parallelogram, a rectangle with rounded
    corners), the one taken may be the other of the two."""
    f = np.float32
    pts = np.asarray(points, f).reshape(-1, 2)
    hull = pts[_convex_hull_order(pts)] if len(pts) else pts
    if len(hull) == 0:
        return (0.0, 0.0), (0.0, 0.0), 0.0
    if len(hull) == 1:
        return (float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0
    h64 = hull.astype(np.float64)
    best = None
    for i in range(len(hull) if len(hull) > 2 else 1):
        e = h64[(i + 1) % len(hull)] - h64[i]
        u = e / math.hypot(e[0], e[1])
        v = np.array([-u[1], u[0]])
        pu, pv = h64 @ u, h64 @ v
        w, h = pu.max() - pu.min(), pv.max() - pv.min()
        if best is None or w * h < best[0]:
            c = u * (pu.max() + pu.min()) / 2 + v * (pv.max() + pv.min()) / 2
            best = (w * h, c, w, h, math.degrees(math.atan2(u[1], u[0])))
    if len(hull) > 2:
        out = _calipers(hull).astype(np.float64)
        w, h = math.hypot(*out[1]), math.hypot(*out[2])
        if abs(w * h - best[0]) <= 1e-6 * best[0]:
            return _rect_in_range(out[0] + (out[1] + out[2]) * 0.5, w, h,
                                  math.degrees(math.atan2(out[1, 1], out[1, 0])))
    return _rect_in_range(*best[1:])


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints(((cx, cy), (w, h), angle))``: the (4, 2) float32
    corners."""
    (cx, cy), (w, h), ang = rect
    a = ang * math.pi / 180.0
    b, c = math.cos(a) * 0.5, math.sin(a) * 0.5
    p0 = (cx - c * h - b * w, cy + b * h - c * w)
    p1 = (cx + c * h - b * w, cy - b * h - c * w)
    return np.asarray([p0, p1, (2 * cx - p0[0], 2 * cy - p0[1]),
                       (2 * cx - p1[0], 2 * cy - p1[1])], np.float32)
