"""The image operations of the data path, in numpy: the port's stand-in for
the ``cv2`` calls of ``xlstm_yolo_tpu/data/`` (the card's machine has
neither OpenCV nor Pillow).

* ``imread`` / ``imwrite``: PNG (8-bit gray, gray+alpha, RGB, RGBA, palette;
  not interlaced) and BMP (8-bit palette, 24- and 32-bit, uncompressed) are
  decoded and encoded here, with the standard library's ``zlib``. Every
  other format of ``IMG_FORMATS`` (JPEG above all) goes through ``cv2`` or
  Pillow, imported inside ``imread``; where neither is installed it raises
  an error that names the format and the packages. Images are RGB uint8
  (H, W, 3), as ``cv2.imread`` then ``COLOR_BGR2RGB`` gives them: alpha is
  dropped, gray is repeated.
* ``resize``: ``cv2.resize(..., INTER_LINEAR)`` on uint8, half-pixel centres,
  in cv2's fixed point (11-bit weights per axis, the rounding of its
  vectorized vertical pass; an exact 2x reduction is cv2's 2x2 mean).
* ``warp_affine`` / ``warp_perspective``: ``cv2.warpAffine`` /
  ``cv2.warpPerspective`` (bilinear, constant border) as OpenCV 5 computes
  them: fp32 source positions and weights, rounded to the nearest level.
* ``rgb2hsv`` / ``hsv2rgb``: ``cv2.cvtColor`` ``COLOR_RGB2HSV`` /
  ``COLOR_HSV2RGB`` on uint8 (hue on cv2's 0-179 scale), with cv2's integer
  tables one way and its fp32 sector formula (truncated, as its vectorized
  loop) the other; ``lut`` is ``cv2.LUT``.
* ``fill_rect``, ``fill_circle``, ``fill_poly``: the shape fills of the
  synthetic dataset writer (pixel centres inside the shape; not cv2's
  rasterizer, which nothing compares against).

``tests/test_torch_data.py`` holds each op against ``cv2`` with the
tolerance it states.
"""
from __future__ import annotations

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


def imread(path: str | Path) -> np.ndarray:
    """Read an image file as RGB uint8 (H, W, 3). PNG and BMP are decoded
    here; the other formats through ``cv2`` (as the JAX package reads them)
    or else Pillow, imported here; neither installed raises."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"cannot read image {p}")
    data = p.read_bytes()
    if data[:8] == _PNG_SIG:
        return _png_decode(data, p)
    if data[:2] == b"BM":
        return _bmp_decode(data, p)
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
            f"neither is installed; the port decodes .png and .bmp itself") from None
    with Image.open(p) as im:
        return np.asarray(im.convert("RGB"))


def imwrite(path: str | Path, img: np.ndarray) -> Path:
    """Write RGB (H, W, 3) or gray (H, W) uint8 as ``.png`` or ``.bmp``."""
    p = Path(path)
    img = np.ascontiguousarray(img, np.uint8)
    if p.suffix.lower() == ".png":
        p.write_bytes(_png_encode(img))
    elif p.suffix.lower() == ".bmp":
        p.write_bytes(_bmp_encode(img))
    else:
        raise ValueError(f"the port writes .png and .bmp, not {p.suffix!r}")
    return p


# ---------------------------------------------------------------------------
# resize (cv2 INTER_LINEAR on uint8)
# ---------------------------------------------------------------------------

def _linear_taps(n_in: int, n_out: int):
    """Per output index: the two source indices and their 11-bit weights,
    as cv2 computes them (fp32 positions, half-pixel centres, edge clamp)."""
    scale = 1.0 / (n_out / n_in)
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    edge = (sx < 0) | (sx >= n_in - 1)
    fx[edge] = 0.0
    sx = np.where(sx < 0, 0, np.minimum(sx, n_in - 1))
    a1 = np.rint(fx * np.float32(2048)).astype(np.int64)
    a0 = np.rint((np.float32(1) - fx) * np.float32(2048)).astype(np.int64)
    return sx, np.minimum(sx + 1, n_in - 1), a0, a1


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
    y0, y1, b0, b1 = _linear_taps(h, h_out)
    src = img.astype(np.int64).reshape(h, w, -1)
    hor = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # (H, w_out, C)
    # the vertical pass of cv2's vectorized loop: each row sum >> 4, a high
    # half product with the 11-bit weight, then a rounding shift by 2
    r0, r1 = hor[y0] >> 4, hor[y1] >> 4
    v = ((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8).reshape(h_out, w_out, *img.shape[2:])


# ---------------------------------------------------------------------------
# warps (cv2 warpAffine / warpPerspective, bilinear, constant border)
# ---------------------------------------------------------------------------

def _remap(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: int) -> np.ndarray:
    """Bilinear sample of uint8 ``img`` at the fp32 source positions (sx,
    sy) (arrays of the output's shape), taps outside the image reading
    ``border``, rounded to the nearest level: cv2's remap of uint8."""
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
    one = np.float32(1)
    acc = np.zeros((*sx.shape, c), np.float32)
    for yy, wy in ((cy0, one - ay), (cy1, ay)):
        for xx, wx in ((cx0, one - ax), (cx1, ax)):
            acc += flat[yy * (w + 2) + xx] * (wy * wx)[..., None]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8).reshape(*sx.shape, *img.shape[2:])


def _grid(size: tuple[int, int]):
    w_out, h_out = int(size[0]), int(size[1])
    ys, xs = np.mgrid[:h_out, :w_out]
    return xs.astype(np.float32), ys.astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, size: tuple[int, int],
                border: int = BORDER) -> np.ndarray:
    """``cv2.warpAffine(img, M, size, borderValue=(border,) * 3)`` for uint8:
    ``M`` (2, 3) maps source to destination; ``size`` is (width, height)."""
    m = np.asarray(M, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a = np.array([[m[1, 1] * d, -m[0, 1] * d, 0.0], [-m[1, 0] * d, m[0, 0] * d, 0.0]])
    a[0, 2] = -a[0, 0] * m[0, 2] - a[0, 1] * m[1, 2]
    a[1, 2] = -a[1, 0] * m[0, 2] - a[1, 1] * m[1, 2]
    a = a.astype(np.float32)
    xs, ys = _grid(size)
    return _remap(img, a[0, 0] * xs + a[0, 1] * ys + a[0, 2],
                  a[1, 0] * xs + a[1, 1] * ys + a[1, 2], border)


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


def hsv2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` for uint8 HSV (..., 3), in
    cv2's fp32 arithmetic, truncated to a level as its vectorized loop (the
    one images wider than a pixel take) does."""
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, f32(0), h)
    tab = np.stack([v, v * (f32(1) - s), v * (f32(1) - s * h), v * (f32(1) - s * (f32(1) - h))],
                   axis=-1)
    idx = _SECTORS[sector]  # (..., 3) = which tab entry is b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    gray = (s == 0)[..., None]
    bgr = np.where(gray, v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255.0)
    return np.clip(np.trunc(rgb), 0, 255).astype(np.uint8)  # cv2's vectorized path truncates


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
