"""Drawing on RGB frames without OpenCV: labelled boxes (upright and
rotated), alpha-blended instance masks, keypoint skeletons, text, and the
solution helpers (regions, track trails, counts, analytics, distances,
workout angles, vision-eye, sweep lines); ``save_one_box`` crops.

Port of ``Colors`` / ``colors``, ``Annotator`` and ``save_one_box`` in
``xlstm_yolo_tpu/utils/annotator.py``, which draws with OpenCV 5. Here a
small rasterizer in numpy stands in for cv2's calls:

* exact to cv2: the palette (the same golden-ratio hue walk), the mask
  blend (the same float32 arithmetic; masks of another size resized by
  ``data.imgproc.resize_linear_f32``, cv2's INTER_LINEAR), filled boxes
  (``rectangle(..., -1)``), the label box's geometry (``text_size`` is
  ``cv2.getTextSize`` for font 0: height ``floor(scale * 1000 / 37 + 0.5)``,
  width 1 plus the characters' integer advances at that pixel size, in a
  thin weight for thickness 1 and a bold one above, tabled in ``_font``),
  and one-pixel LINE_8 strokes (Bresenham as ``cv::LineIterator``);
* close to cv2: thick strokes (capsules of radius ``(lw + lw % 2) / 2``
  about the segment, as cv2 widens them), anti-aliased edges (a coverage
  that falls off with the distance of the pixel centre from the shape,
  fitted to cv2 5's), circles, and the glyphs: the outlines of cv2's face
  for printable ASCII in both weights, traced from a rendering at 1000 px
  (``_font.THIN_OUTLINES`` / ``BOLD_OUTLINES``,
  ``tools/derive_annotator_font.py``), filled with their area coverage
  (always anti-aliased, as cv2 5 draws text whatever the line type).

Images are RGB uint8 (H, W, 3); ``save`` writes through
``data.imgproc.imwrite`` (JPEG at quality 95: the bytes ``cv2.imwrite``
writes for the same pixels).
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from ..data.imgproc import imwrite, resize_linear_f32
from . import _font

LINE_8, LINE_AA = 8, 16


def _hsv2rgb(h: float, s: float, v: float) -> tuple[int, int, int]:
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    r, g, b = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))[i]
    return int(r * 255), int(g * 255), int(b * 255)


class Colors:
    """The class palette: a golden-ratio hue walk at two saturation and value
    tiers (index i always gives the same colour), and ``pose_palette`` for
    keypoint groups and limbs."""

    def __init__(self, n: int = 40):
        phi = (math.sqrt(5) - 1) / 2
        self.palette = [_hsv2rgb((0.04 + i * phi) % 1.0, 0.75 if i % 2 else 0.95,
                                 0.95 if i % 3 else 0.80) for i in range(n)]
        self.n = len(self.palette)
        self.pose_palette = np.array([_hsv2rgb(h / 20.0, 0.85, 0.95) for h in range(20)],
                                     dtype=np.uint8)

    def __call__(self, i, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()

# the COCO 17-keypoint skeleton and the colour groups of its points and limbs
COCO_SKELETON = [(15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
                 (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
                 (1, 3), (2, 4), (3, 5), (4, 6)]
_KPT_COLOR_ID = [16, 16, 16, 16, 16, 9, 9, 9, 9, 9, 9, 0, 0, 0, 0, 0, 0]
_LIMB_COLOR_ID = [0, 0, 0, 0, 9, 9, 9, 9, 9, 9, 9, 9, 16, 16, 16, 16, 16, 16, 16]

# ---------------------------------------------------------------------------
# text metrics (cv2.getTextSize for font 0)
# ---------------------------------------------------------------------------

_CHARS = [chr(c) for c in range(32, 127)]
_INDEX = {c: i for i, c in enumerate(_CHARS)}
_WEIGHTS = {w: (rates, {p: dict(f) for p, f in fixes.items()})
            for w, rates, fixes in ((0, _font.THIN_RATES, _font.THIN_FIXES),
                                    (1, _font.BOLD_RATES, _font.BOLD_FIXES))}


def _glyph_edges(polys) -> np.ndarray:
    """A glyph's outline edges (E, 2, 2) as ((x0, y0), (x1, y1)) in units of
    the pixel size; the horizontal ones, which cross no scanline, left out."""
    if not polys:
        return np.zeros((0, 2, 2))
    e = np.concatenate([np.stack([q, np.roll(q, -1, 0)], 1) for q in
                        (np.asarray(p, np.float64).reshape(-1, 2) / 1000 for p in polys)])
    return e[e[:, 0, 1] != e[:, 1, 1]]


_GLYPH_EDGES = {w: {ch: _glyph_edges(polys) for ch, polys in outlines.items()}
                for w, outlines in ((0, _font.THIN_OUTLINES), (1, _font.BOLD_OUTLINES))}
_SUBROWS = 16  # scanlines a pixel row when filling a glyph


def _pixel_size(scale: float) -> int:
    return int(math.floor(scale * 1000 / 37 + 0.5))


def _advances(text: str, size: int, thickness: int) -> list:
    rates, fixes = _WEIGHTS[int(thickness > 1)]
    fix = fixes.get(size, {})
    out = []
    for ch in text:
        i = _INDEX.get(ch, _INDEX["?"])
        out.append(fix[i] if i in fix else int(rates[i] * size))
    return out


def text_size(text: str, scale: float, thickness: int = 1) -> tuple[int, int]:
    """(width, height) of ``text`` as ``cv2.getTextSize(text, 0, scale,
    thickness)[0]`` gives it."""
    if not text:
        return 0, 0
    size = _pixel_size(scale)
    return 1 + sum(_advances(text, size, thickness)), size


# ---------------------------------------------------------------------------
# the rasterizer
# ---------------------------------------------------------------------------

# coverage of a pixel whose centre lies d px outside a shape (0 inside):
# fitted to cv2 5's LINE_AA edges (0.21 at one pixel, 0.1 at a diagonal one)
_AA_D = np.array([0.0, 0.24, 0.47, 1.0, 1.414, 1.8])
_AA_A = np.array([1.0, 0.86, 0.6, 0.215, 0.1, 0.0])
_AA_REACH = 2
# a one-pixel LINE_AA line: alpha against the distance from the segment
_THIN_D = np.array([0.0, 0.32, 0.63, 0.95, 1.26, 1.5])
_THIN_A = np.array([0.93, 0.84, 0.55, 0.24, 0.06, 0.0])
# a LINE_AA disk: a steeper edge than a polygon's
_DISK_D = np.array([0.0, 0.33])
_DISK_A = np.array([1.0, 0.0])


def _window(im, x1, y1, x2, y2):
    """The clipped integer window [x1, x2] x [y1, y2] of ``im``, with its
    pixel-centre grids; None where it is empty."""
    h, w = im.shape[:2]
    xa, ya = max(int(math.floor(x1)), 0), max(int(math.floor(y1)), 0)
    xb, yb = min(int(math.ceil(x2)), w - 1), min(int(math.ceil(y2)), h - 1)
    if xa > xb or ya > yb:
        return None
    ys, xs = np.mgrid[ya:yb + 1, xa:xb + 1].astype(np.float64)
    return ya, xa, ys, xs


def _blend(im, ya, xa, alpha, color):
    """im := round(im + (color - im) * alpha) over the window at (ya, xa)."""
    if not alpha.any():
        return
    h, w = alpha.shape
    sl = im[ya:ya + h, xa:xa + w]
    c = np.asarray(color, np.float64)[:sl.shape[-1]] if sl.ndim == 3 else float(color[0])
    a = alpha[..., None] if sl.ndim == 3 else alpha
    sl[...] = np.floor(sl + (c - sl) * a + 0.5).astype(np.uint8)


def _coverage(dist_out, line_type):
    """Alpha from the distance outside the shape: 1 inside for LINE_8, the
    fitted falloff for LINE_AA."""
    if line_type == LINE_AA:
        return np.interp(dist_out, _AA_D, _AA_A)
    return (dist_out <= 1e-9).astype(np.float64)


def _seg_dist(xs, ys, a, b):
    ax, ay = a
    bx, by = b
    dx, dy = bx - ax, by - ay
    n = dx * dx + dy * dy
    t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / n, 0, 1) if n > 0 else 0.0
    return np.hypot(xs - (ax + t * dx), ys - (ay + t * dy))


def _half_width(thickness: int) -> float:
    """cv2's half width of a thick stroke: lw / 2, odd widths rounded up."""
    return (thickness + (thickness & 1)) / 2


def _clip_line(w, h, x1, y1, x2, y2):
    """``cv::clipLine``: the segment cut to the image, or None outside it."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _line1(im, p0, p1, color):
    """A one-pixel LINE_8 segment, Bresenham as ``cv::LineIterator``
    (clipped to the image by ``cv::clipLine``, then left to right)."""
    clipped = _clip_line(im.shape[1], im.shape[0], int(p0[0]), int(p0[1]), int(p1[0]),
                         int(p1[1]))
    if clipped is None:
        return
    x0, y0, x1, y1 = clipped
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x0, y0
    pts = []
    for _ in range(dx + 1):
        pts.append((x, y))
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0
    pts = np.asarray(pts)
    im[pts[:, 1], pts[:, 0]] = (np.asarray(color, np.uint8)[:im.shape[-1]] if im.ndim == 3
                                else color[0])


def _polyline(im, pts, closed, color, thickness, line_type):
    """Segments through ``pts`` (closed back to the first with ``closed``),
    each drawn on its own, as cv2 draws them: one-pixel LINE_8 lines, or
    capsules of cv2's half width."""
    pts = [(float(x), float(y)) for x, y in np.asarray(pts, np.float64).reshape(-1, 2)]
    if not pts:
        return
    segs = list(zip(pts[:-1], pts[1:])) + ([(pts[-1], pts[0])] if closed and len(pts) > 2
                                           else [])
    if not segs:
        segs = [(pts[0], pts[0])]
    if thickness <= 1 and line_type != LINE_AA:
        for a, b in segs:
            _line1(im, a, b, color)
        return
    r = _half_width(thickness) if thickness > 1 else 0.0
    reach = r + (_AA_REACH if line_type == LINE_AA else 1)
    for a, b in segs:
        win = _window(im, min(a[0], b[0]) - reach, min(a[1], b[1]) - reach,
                      max(a[0], b[0]) + reach, max(a[1], b[1]) + reach)
        if win is None:
            continue
        ya, xa, ys, xs = win
        d = _seg_dist(xs, ys, a, b)
        if thickness <= 1:
            alpha = np.interp(d, _THIN_D, _THIN_A)
        elif line_type == LINE_AA:
            alpha = _coverage(np.maximum(d - r, 0), LINE_AA)
        else:  # cv2 fills the quad with its LINE_8 edges: about half a pixel wider
            alpha = (d <= r + 0.5).astype(np.float64)
        _blend(im, ya, xa, alpha, color)


def _rectangle(im, p1, p2, color, thickness=1, line_type=LINE_8):
    """``cv2.rectangle``: filled (thickness < 0) exactly over [x1, x2] x
    [y1, y2] (an anti-aliased fill adds the fitted fringe), else the
    outline as a closed polyline."""
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    if thickness >= 0:
        _polyline(im, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], True, color, thickness,
                  line_type)
        return
    if x2 < 0 or y2 < 0 or x1 >= im.shape[1] or y1 >= im.shape[0]:
        return  # cv2 fills nothing, fringe included, for a box off the image
    reach = _AA_REACH if line_type == LINE_AA else 0
    win = _window(im, x1 - reach, y1 - reach, x2 + reach, y2 + reach)
    if win is None:
        return
    ya, xa, ys, xs = win
    d = np.hypot(np.maximum(np.maximum(x1 - xs, xs - x2), 0),
                 np.maximum(np.maximum(y1 - ys, ys - y2), 0))
    _blend(im, ya, xa, _coverage(d, line_type), color)


def _circle(im, center, radius, color, thickness=1, line_type=LINE_8):
    """``cv2.circle``: a disk (thickness < 0) or a ring of cv2's half width."""
    cx, cy, r = float(int(center[0])), float(int(center[1])), float(radius)
    hw = 0.0 if thickness < 0 else (_half_width(thickness) if thickness > 1 else 0.5)
    reach = r + hw + (_AA_REACH if line_type == LINE_AA else 0)
    win = _window(im, cx - reach, cy - reach, cx + reach, cy + reach)
    if win is None:
        return
    ya, xa, ys, xs = win
    rho = np.hypot(xs - cx, ys - cy)
    if thickness < 0:
        d = np.maximum(rho - r, 0)
        alpha = np.interp(d, _DISK_D, _DISK_A) if line_type == LINE_AA else _coverage(d, LINE_8)
    else:
        alpha = _coverage(np.maximum(np.abs(rho - r) - hw, 0), line_type)
    _blend(im, ya, xa, alpha, color)


def _glyph_coverage(edges, size, ox, oy, xa, ya, w, h) -> np.ndarray:
    """The area coverage (h, w) of a glyph's outlines at pixel size ``size``
    and origin (ox, oy) over the window whose top-left pixel is (xa, ya):
    even-odd spans on _SUBROWS scanlines a row, each span's exact share of
    the pixels it crosses (pixel (x, y) covers [x, x + 1] x [y, y + 1])."""
    x0, x1 = edges[:, 0, 0] * size + (ox - xa), edges[:, 1, 0] * size + (ox - xa)
    y0, y1 = edges[:, 0, 1] * size + (oy - ya), edges[:, 1, 1] * size + (oy - ya)
    ys = (np.arange(h * _SUBROWS)[:, None] + 0.5) / _SUBROWS
    crossed = (np.minimum(y0, y1) <= ys) & (np.maximum(y0, y1) > ys)
    xs = np.where(crossed, x0 + (ys - y0) / (y1 - y0) * (x1 - x0), np.inf)
    xs.sort(1)
    n = int(crossed.sum(1).max())
    xs = xs[:, :n + (n & 1)]
    a, b = xs[:, 0::2], xs[:, 1::2]
    inside = np.isfinite(b)
    a, b = np.where(inside, a, 0.0), np.where(inside, b, 0.0)
    cum = np.clip(np.arange(w + 1.0) - a[..., None], 0, (b - a)[..., None]).sum(1)
    return np.diff(cum, axis=1).reshape(h, _SUBROWS, w).mean(1)


def _put_text(im, text, org, scale, color, thickness=1):
    """``cv2.putText`` with font 0: each glyph's outlines at pixel size
    ``floor(scale * 1000 / 37 + 0.5)`` from the baseline point ``org``,
    advanced by cv2's integer advances, filled with their coverage (the
    larger where two glyphs meet) and blended once."""
    text = str(text)
    size = _pixel_size(scale)
    if not text or size <= 0:
        return
    font = _GLYPH_EDGES[int(thickness > 1)]
    ox, oy = int(org[0]), int(org[1])
    pieces, pen = [], ox
    for ch, adv in zip(text, _advances(text, size, thickness)):
        e = font.get(ch, font["?"])
        if len(e):
            xs, ys = e[..., 0] * size + pen, e[..., 1] * size + oy
            pieces.append((e, pen, int(math.floor(xs.min())), int(math.floor(ys.min())),
                           int(math.ceil(xs.max())), int(math.ceil(ys.max()))))
        pen += adv
    h, w = im.shape[:2]
    if not pieces:
        return
    wx0, wy0 = max(min(p[2] for p in pieces), 0), max(min(p[3] for p in pieces), 0)
    wx1, wy1 = min(max(p[4] for p in pieces), w), min(max(p[5] for p in pieces), h)
    if wx0 >= wx1 or wy0 >= wy1:
        return
    alpha = np.zeros((wy1 - wy0, wx1 - wx0))
    for e, pen, gx0, gy0, gx1, gy1 in pieces:
        xa, ya, xb, yb = max(gx0, wx0), max(gy0, wy0), min(gx1, wx1), min(gy1, wy1)
        if xa < xb and ya < yb:
            sl = alpha[ya - wy0:yb - wy0, xa - wx0:xb - wx0]
            np.maximum(sl, np.clip(_glyph_coverage(e, size, pen, oy, xa, ya, xb - xa, yb - ya),
                                   0, 1), out=sl)
    _blend(im, wy0, wx0, alpha, color)


# ---------------------------------------------------------------------------
# the annotator
# ---------------------------------------------------------------------------


def _color(c):
    return tuple(int(x) for x in c)


class Annotator:
    """Draw detection, segmentation, pose and solution overlays on a copy of
    an RGB frame; ``result()`` returns it. Line width ``lw`` defaults to
    0.3% of the mean side (at least 2), font scale ``lw / 3``, text
    thickness ``lw - 1`` (at least 1), as in JAX."""

    def __init__(self, im: np.ndarray, line_width: int | None = None,
                 font_scale: float | None = None):
        self.im = np.ascontiguousarray(im).copy()
        if self.im.dtype != np.uint8:
            self.im = (np.clip(self.im, 0, 1) * 255).astype(np.uint8)
        self.h, self.w = self.im.shape[:2]
        self.lw = line_width or max(round((self.h + self.w) / 2 * 0.003), 2)
        self.fs = font_scale or self.lw / 3
        self.tf = max(self.lw - 1, 1)

    # -- core ----------------------------------------------------------

    def box_label(self, box, label: str = "", color=(128, 128, 128),
                  txt_color=(255, 255, 255), rotated: bool = False):
        """A box with its label in a filled box above it (below where it
        would leave the image); ``rotated`` takes (4, 2) corners."""
        color = _color(color)
        if rotated:
            pts = np.asarray(box, np.int32).reshape(-1, 2)
            _polyline(self.im, pts, True, color, self.lw, LINE_8)
            p1 = (int(pts[:, 0].min()), int(pts[:, 1].min()))
        else:
            p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
            _rectangle(self.im, p1, p2, color, self.lw, LINE_AA)
        if label:
            tw, th = text_size(str(label), self.fs, self.tf)
            outside = p1[1] - th - 3 >= 0
            p3 = (p1[0] + tw, p1[1] - th - 3 if outside else p1[1] + th + 3)
            _rectangle(self.im, p1, p3, color, -1, LINE_AA)
            _put_text(self.im, str(label), (p1[0], p1[1] - 2 if outside else p1[1] + th + 2),
                      self.fs, txt_color, self.tf)

    def masks(self, masks: np.ndarray, colors_, alpha: float = 0.5):
        """Alpha-blend (N, h, w) masks (bool or float, > 0.5 is on) in
        ``colors_``; masks of another size are resized to the frame first.
        Where masks overlap their colours are averaged."""
        if len(masks) == 0:
            return
        masks = np.asarray(masks)
        if masks.shape[1:] != (self.h, self.w):
            masks = np.stack([resize_linear_f32(m.astype(np.float32), (self.w, self.h))
                              for m in masks])
        on = masks > 0.5
        cols = np.asarray([_color(c) for c in colors_], np.float32)
        cnt = on.sum(0)
        colored = np.tensordot(on.astype(np.float32), cols, axes=(0, 0))
        sel = cnt > 0
        blend = self.im.astype(np.float32)
        blend[sel] = (1 - alpha) * blend[sel] + alpha * colored[sel] / cnt[sel, None]
        self.im = blend.astype(np.uint8)

    def kpts(self, kpts: np.ndarray, radius: int | None = None, kpt_line: bool = True,
             conf_thres: float = 0.25):
        """One instance's (K, 2 or 3) keypoints as disks, and with 17 of
        them the COCO skeleton's limbs."""
        kpts = np.asarray(kpts)
        radius = radius or max(self.lw, 2)
        is_pose = len(kpts) == 17
        for ki, k in enumerate(kpts):
            if len(k) >= 3 and k[2] < conf_thres:
                continue
            if k[0] <= 0 and k[1] <= 0:
                continue
            c = self.pose_color(_KPT_COLOR_ID[ki]) if is_pose else (0, 255, 0)
            _circle(self.im, (int(k[0]), int(k[1])), radius, c, -1, LINE_AA)
        if kpt_line and is_pose:
            for li, (a, b) in enumerate(COCO_SKELETON):
                ka, kb = kpts[a], kpts[b]
                if len(ka) >= 3 and (ka[2] < conf_thres or kb[2] < conf_thres):
                    continue
                if (ka[0] <= 0 and ka[1] <= 0) or (kb[0] <= 0 and kb[1] <= 0):
                    continue
                _polyline(self.im, [(int(ka[0]), int(ka[1])), (int(kb[0]), int(kb[1]))], False,
                          self.pose_color(_LIMB_COLOR_ID[li]), max(self.lw // 2, 1), LINE_AA)

    @staticmethod
    def pose_color(i: int):
        return _color(colors.pose_palette[i % len(colors.pose_palette)])

    def rectangle(self, xy, fill=None, outline=None, width: int = 1):
        p1, p2 = (int(xy[0]), int(xy[1])), (int(xy[2]), int(xy[3]))
        if fill is not None:
            _rectangle(self.im, p1, p2, _color(fill), -1)
        if outline is not None:
            _rectangle(self.im, p1, p2, _color(outline), width)

    def text(self, xy, text: str, txt_color=(255, 255, 255), box_style: bool = False,
             bg_color=(0, 0, 0)):
        x, y = int(xy[0]), int(xy[1])
        if box_style:
            tw, th = text_size(str(text), self.fs, self.tf)
            _rectangle(self.im, (x - 2, y - th - 4), (x + tw + 2, y + 4), _color(bg_color), -1)
        _put_text(self.im, str(text), (x, y), self.fs, txt_color, self.tf)

    def circle_label(self, box, label: str = "", color=(128, 128, 128),
                     txt_color=(255, 255, 255), margin: int = 2):
        """A filled circle with the label at a box's centre."""
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        scale = 0.15 * self.fs * 3
        tw, th = text_size(str(label), scale, self.tf)
        radius = int((max(tw, th)) / 2 + margin) + self.tf
        _circle(self.im, (cx, cy), radius, _color(color), -1)
        _put_text(self.im, str(label), (cx - tw // 2, cy + th // 2), scale, txt_color, self.tf)

    def text_label(self, box, label: str = "", color=(128, 128, 128),
                   txt_color=(255, 255, 255), margin: int = 5):
        """A filled box with the label at a box's centre."""
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        tw, th = text_size(str(label), self.fs, self.tf)
        _rectangle(self.im, (cx - tw // 2 - margin, cy - th // 2 - margin),
                   (cx + tw // 2 + margin, cy + th // 2 + margin), _color(color), -1)
        _put_text(self.im, str(label), (cx - tw // 2, cy + th // 2), self.fs, txt_color,
                  self.tf)

    # -- solution helpers ------------------------------------------------

    def draw_region(self, reg_pts, color=(0, 255, 0), thickness: int = 5):
        """A counting line (two points) or region polygon."""
        pts = np.asarray(reg_pts, np.int32).reshape(-1, 2)
        _polyline(self.im, pts, len(pts) != 2, _color(color), thickness, LINE_8)

    def draw_centroid_and_tracks(self, track, color=(255, 0, 255), thickness: int = 2):
        """A track's trail and a disk at its current centroid."""
        pts = np.asarray(track, np.int32).reshape(-1, 2)
        _polyline(self.im, pts, False, _color(color), thickness, LINE_8)
        _circle(self.im, tuple(pts[-1]), thickness * 2, _color(color), -1)

    def queue_counts_display(self, label: str, points=None, region_color=(255, 255, 255),
                             txt_color=(0, 0, 0)):
        """The queue count centred in the region polygon."""
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        cx, cy = pts[:, 0].mean(), pts[:, 1].mean()
        self.text((cx, cy), label, txt_color=txt_color, box_style=True, bg_color=region_color)

    def display_analytics(self, rows: dict, txt_color=(255, 255, 255), bg_color=(40, 40, 40),
                          margin: int = 10):
        """Key: value rows stacked in the top-right corner."""
        y = margin + 20
        for k, v in rows.items():
            s = f"{k}: {v}"
            tw, th = text_size(s, self.fs, self.tf)
            x = self.w - tw - margin
            _rectangle(self.im, (x - 4, y - th - 4), (x + tw + 4, y + 4), _color(bg_color), -1)
            _put_text(self.im, s, (x, y), self.fs, txt_color, self.tf)
            y += th + margin

    def plot_angle_and_count_and_stage(self, angle, count, stage, center_kpt,
                                       color=(104, 31, 17), txt_color=(255, 255, 255)):
        """The workout monitor's angle, count and stage at a joint."""
        x, y = int(center_kpt[0]), int(center_kpt[1])
        for i, s in enumerate((f"{float(angle):.0f} deg", f"reps {count}", f"{stage}")):
            self.text((x, y + i * int(22 * self.fs * 3 / 2)), s, txt_color=txt_color,
                      box_style=True, bg_color=color)

    def seg_bbox(self, mask_xy, mask_color=(255, 0, 255), label: str | None = None,
                 txt_color=(255, 255, 255)):
        """A segment's outline and, with ``label``, its label at the centre."""
        pts = np.asarray(mask_xy, np.int32).reshape(-1, 2)
        _polyline(self.im, pts, True, _color(mask_color), self.lw, LINE_8)
        if label:
            cx, cy = pts[:, 0].mean(), pts[:, 1].mean()
            self.text((cx, cy), label, txt_color=txt_color, box_style=True, bg_color=mask_color)

    def plot_distance_and_line(self, distance_m: float, centroids, line_color=(104, 31, 17),
                               centroid_color=(255, 0, 255)):
        """The line between two centroids, their disks and the distance."""
        (x1, y1), (x2, y2) = (tuple(int(v) for v in c) for c in centroids)
        _polyline(self.im, [(x1, y1), (x2, y2)], False, _color(line_color), self.lw, LINE_8)
        for c in ((x1, y1), (x2, y2)):
            _circle(self.im, c, self.lw * 2, _color(centroid_color), -1)
        self.text((20, 40), f"distance: {distance_m:.2f} m", box_style=True, bg_color=line_color)

    def visioneye(self, box, center_point, color=(235, 219, 11), pin_color=(255, 0, 255)):
        """A line from the eye point to the object's centre."""
        cx, cy = int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)
        cp = (int(center_point[0]), int(center_point[1]))
        _circle(self.im, cp, self.lw * 2, _color(pin_color), -1)
        _circle(self.im, (cx, cy), self.lw * 2, _color(color), -1)
        _polyline(self.im, [cp, (cx, cy)], False, _color(color), self.lw, LINE_8)

    def sweep_annotator(self, line_x: int = 0, line_y: int = 0, label: str | None = None,
                        color=(221, 0, 186), txt_color=(255, 255, 255)):
        """A vertical sweep line with an optional label."""
        _polyline(self.im, [(int(line_x), 0), (int(line_x), int(line_y or self.h))], False,
                  _color(color), self.lw, LINE_8)
        if label:
            self.text((line_x + 5, (line_y or self.h) // 2), label, txt_color=txt_color,
                      box_style=True, bg_color=color)

    # -- io --------------------------------------------------------------

    def result(self) -> np.ndarray:
        return self.im

    def save(self, filename: str | Path = "image.jpg"):
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        return imwrite(filename, self.im)


def save_one_box(xyxy, im: np.ndarray, file: str | Path = "im.jpg", gain: float = 1.02,
                 pad: int = 10, square: bool = False, save: bool = True) -> np.ndarray:
    """The crop of a box grown by ``gain`` and ``pad`` px about its centre
    (made square with ``square``), written to ``file`` with ``save``."""
    b = np.asarray(xyxy, np.float32).reshape(-1, 4)[0]
    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    w, h = (b[2] - b[0]) * gain + pad, (b[3] - b[1]) * gain + pad
    if square:
        w = h = max(w, h)
    x1, y1 = max(int(cx - w / 2), 0), max(int(cy - h / 2), 0)
    x2, y2 = min(int(cx + w / 2), im.shape[1]), min(int(cy + h / 2), im.shape[0])
    crop = im[y1:y2, x1:x2]
    if save:
        Path(file).parent.mkdir(parents=True, exist_ok=True)
        imwrite(file, crop)
    return crop
