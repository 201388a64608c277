"""Derive the annotator's text metrics and glyph outlines from OpenCV.

Run in an environment with OpenCV 5 (``cv2``); prints the Python source of
``xlstm_yolo_torch/utils/_font.py``:

    python tools/derive_annotator_font.py > xlstm_yolo_torch/utils/_font.py

OpenCV 5 draws ``FONT_HERSHEY_SIMPLEX`` (font 0) with a TrueType face. Its
``getTextSize(text, 0, scale, thickness)`` is, as measured here:
height ``P = floor(scale * 1000 / 37 + 0.5)``, width ``1 + sum`` of the
characters' integer advances at pixel size ``P`` in one of two weights
(thickness 1 or less, and 2 or more); ``(0, 0)`` for ''. The advances are
written as ``floor(a * P)`` plus a table of the sizes 1-160 where that is
off. The glyphs are the face's outlines in each weight, traced from a
rendering at 1000 px (``outlines``): the annotator fills them with their
area coverage, as OpenCV fills the face (OpenCV 5 draws text anti-aliased
whatever the line type).
"""
from __future__ import annotations

import cv2
import numpy as np

CHARS = [chr(c) for c in range(32, 127)]
K = 1000 / 37
MAX_P = 160
GLYPH_P = 1000
OUTLINE_EPS = 3.0


def advances(th: int) -> dict:
    out = {}
    for P in range(1, MAX_P + 1):
        s = P / K
        out[P] = [(cv2.getTextSize(c * 3, 0, s, th)[0][0] - 1) // 3 for c in CHARS]
    return out


def fit_rates(adv: dict) -> list:
    """Per character the rate ``a`` that makes ``floor(a * P)`` right at
    the most sizes (candidates: the interval ends of every size)."""
    rates = []
    for i in range(len(CHARS)):
        cands = sorted({(adv[P][i] + 0.5) / P for P in adv} | {adv[P][i] / P + 1e-9 for P in adv})
        best = max(cands, key=lambda a: sum(int(a * P) == adv[P][i] for P in adv))
        rates.append(round(best, 6))
    return rates


def outlines(c: str, th: int) -> list:
    """The glyph of ``c`` in the weight of thickness ``th``: the outlines of
    OpenCV's face rendered at GLYPH_P px (the contours of its pixels at or
    above half coverage, every one, holes too, simplified to OUTLINE_EPS px),
    in thousandths of the pixel size, relative to the text origin (x right,
    y down from the baseline) in the coordinates where pixel (x, y) covers
    [x, x + 1] x [y, y + 1]; each polygon a flat list x0, y0, x1, y1, ..."""
    im = np.zeros((int(GLYPH_P * 1.8), int(GLYPH_P * 1.6)), np.uint8)
    ox, oy = int(GLYPH_P * 0.3), int(GLYPH_P * 1.3)
    cv2.putText(im, c, (ox, oy), 0, GLYPH_P / K, 255, th, cv2.LINE_AA)
    contours, _ = cv2.findContours((im >= 128).astype(np.uint8), cv2.RETR_LIST,
                                   cv2.CHAIN_APPROX_NONE)
    out = []
    for cc in contours:
        poly = cv2.approxPolyDP(cc.astype(np.float32), OUTLINE_EPS, True)[:, 0]
        q = np.round((poly.astype(np.float64) + 0.5 - (ox, oy)) * 1000 / GLYPH_P).astype(int)
        out.append([int(v) for v in q.reshape(-1)])
    return out


def main():
    print('"""The annotator\'s font: OpenCV 5\'s text metrics for font 0 and the')
    print("outlines of its face for printable ASCII in both weights, derived by")
    print('``tools/derive_annotator_font.py`` (generated; do not edit by hand)."""')
    for th, name in ((1, "THIN"), (2, "BOLD")):
        adv = advances(th)
        rates = fit_rates(adv)
        fixes = {}
        for P in adv:
            f = [(i, adv[P][i]) for i in range(len(CHARS)) if int(rates[i] * P) != adv[P][i]]
            if f:
                fixes[P] = f
        print(f"{name}_RATES = {rates!r}")
        print(f"{name}_FIXES = {{")
        for P, f in fixes.items():
            print(f"    {P}: {f!r},")
        print("}")
        print(f"{name}_OUTLINES = {{")
        for c in CHARS:
            print(f"    {c!r}: {outlines(c, th)!r},".replace(", ", ","))
        print("}")
    print(f"MAX_P = {MAX_P}")


if __name__ == "__main__":
    main()
