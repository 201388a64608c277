"""BoT-SORT: ByteTrack with camera-motion compensation and optional ReID
features, on the host in numpy.

Port of ``xlstm_yolo_tpu/trackers/bot_sort.py``: ``GMC``, ``BOTrack`` (a track
with a Kalman state over (cx, cy, w, h) and an exponentially smoothed
feature) and ``BOTSORT`` (before each association the tracked and lost
tracks' centres move by the frame's camera motion; the cost is the
score-fused IoU, or its minimum with the halved cosine cost of the
features where ``with_reid`` and every detection has one).

``GMC``'s default method, ``sparseOptFlow``, runs without OpenCV: the JAX
package calls ``cv2.goodFeaturesToTrack``, ``cv2.calcOpticalFlowPyrLK`` and
``cv2.estimateAffinePartial2D``, and this module computes each as OpenCV
does (``good_features``, ``pyr_lk``, ``affine_partial_ransac``) on the gray
frame that ``data.imgproc``'s ``rgb2gray`` and ``resize`` give bit for bit.
The Lucas-Kanade windows keep OpenCV's fixed point (images times 32, 14-bit
bilinear weights, Scharr derivatives); their sums are exact integers where
OpenCV adds float32 lanes, which round once a sum passes 2^24, so a point's
flow can differ from OpenCV's in the last bits (on the tests' frames it
did not). RANSAC draws its pairs from a
``np.random.Generator`` seeded in the constructor, not from OpenCV's
generator: on consistent motion every draw finds the same inliers, and the
least-squares refinement on them decides the result. ``orb``, ``sift`` and
``ecc`` call OpenCV as JAX does; without ``cv2`` they raise an
``ImportError`` that names it.
"""
from __future__ import annotations

import numpy as np

from ..data.imgproc import resize, rgb2gray
from .byte_tracker import BYTETracker, STrack
from .kalman import KalmanFilterXYWH
from .matching import embedding_distance, iou_distance

CV2_METHODS = ("orb", "sift", "ecc")
LK_WIN = 21  # calcOpticalFlowPyrLK's default window (21 x 21), 3 pyramid levels
LK_LEVELS = 3
LK_ITERS, LK_EPS = 30, 0.01  # its termination: 30 iterations or a step of 0.01 px
LK_MIN_EIG = 1e-4
W_BITS = 14  # the fixed point of the bilinear weights
FLT_SCALE = np.float32(1.0 / (1 << 20))


def _import_cv2(method: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"GMC method {method!r} needs cv2 (OpenCV), which is not installed; "
                          f"'sparseOptFlow' and 'none' run without it") from e
    return cv2


def _reflect(img: np.ndarray, pad: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT_101 on the two image axes."""
    return np.pad(img, [(pad, pad), (pad, pad)] + [(0, 0)] * (img.ndim - 2), mode="reflect")


def min_eigen(gray: np.ndarray) -> np.ndarray:
    """``cv2.cornerMinEigenVal(gray, 3, 3)``: 3 x 3 Sobel derivatives scaled
    by 1 / (4 * 3 * 255), the structure tensor summed over 3 x 3 (both with
    BORDER_REFLECT_101) and its smaller eigenvalue, float32."""
    g = _reflect(gray.astype(np.int32), 1)
    sm_v = g[:-2] + 2 * g[1:-1] + g[2:]
    sm_h = g[:, :-2] + 2 * g[:, 1:-1] + g[:, 2:]
    scale = np.float32(1.0 / (4 * 3 * 255))
    dx = (sm_v[:, 2:] - sm_v[:, :-2]).astype(np.float32) * scale
    dy = (sm_h[2:] - sm_h[:-2]).astype(np.float32) * scale

    def box(a):
        r = _reflect(a, 1)
        r = r[:, :-2] + r[:, 1:-1] + r[:, 2:]
        return r[:-2] + r[1:-1] + r[2:]

    xx, xy, yy = box(dx * dx), box(dx * dy), box(dy * dy)
    a, c = xx * np.float32(0.5), yy * np.float32(0.5)
    return (a + c) - np.sqrt((a - c) * (a - c) + xy * xy)


def good_features(gray: np.ndarray, max_corners: int = 200, quality: float = 0.01,
                  min_distance: float = 10.0) -> np.ndarray | None:
    """``cv2.goodFeaturesToTrack(gray, max_corners, quality, min_distance)``
    (block 3, Shi-Tomasi): the minimum eigenvalue, zeroed at or below
    ``quality`` times its maximum, the local maxima of 3 x 3 away from the
    one-pixel border, taken in order of response (equal responses: the
    later pixel first, as OpenCV's sort) unless one already taken lies
    nearer than ``min_distance``. -> (n, 1, 2) float32 (x, y), or None."""
    eig = min_eigen(gray)
    h, w = eig.shape
    eig = np.where(eig > np.float32(float(eig.max()) * quality), eig, np.float32(0))
    p = np.pad(eig, 1, mode="edge")
    dil = np.max(np.stack([p[i:i + h, j:j + w] for i in range(3) for j in range(3)]), 0)
    cand = np.zeros_like(eig, bool)
    cand[1:-1, 1:-1] = (eig[1:-1, 1:-1] != 0) & (eig[1:-1, 1:-1] == dil[1:-1, 1:-1])
    flat = np.flatnonzero(cand)
    order = flat[np.lexsort((-flat, -eig.ravel()[flat]))]
    r = int(np.ceil(min_distance))
    blocked = np.zeros((h + 2 * r, w + 2 * r), bool)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disk = dx * dx + dy * dy < min_distance * min_distance
    out = []
    for y, x in zip(*np.divmod(order, w)):
        if min_distance > 0 and blocked[y + r, x + r]:
            continue
        out.append((x, y))
        if len(out) == max_corners:
            break
        blocked[y:y + 2 * r + 1, x:x + 2 * r + 1] |= disk
    return np.asarray(out, np.float32).reshape(-1, 1, 2) if out else None


def pyr_down(img: np.ndarray) -> np.ndarray:
    """``cv2.pyrDown`` of uint8: the 5 x 5 binomial kernel, sum / 256
    rounded, BORDER_REFLECT_101, every second pixel."""
    h, w = img.shape
    p = _reflect(img.astype(np.int32), 2)
    k = (1, 4, 6, 4, 1)
    rows = sum(k[i] * p[i:i + h] for i in range(5))[::2]
    out = sum(k[j] * rows[:, j:j + w] for j in range(5))[:, ::2]
    return ((out + 128) >> 8).astype(np.uint8)


def pyramid(img: np.ndarray, levels: int = LK_LEVELS, win: int = LK_WIN) -> list:
    """``cv2.buildOpticalFlowPyramid``'s levels: halved (rounding up) while
    both sides of the next level exceed the window."""
    pyr = [img]
    for _ in range(levels):
        h, w = pyr[-1].shape
        if (w + 1) // 2 <= win or (h + 1) // 2 <= win:
            break
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr(img: np.ndarray) -> np.ndarray:
    """The Scharr derivatives of uint8 ``img`` as ``calcOpticalFlowPyrLK``
    takes them (BORDER_REFLECT_101), (h, w, 2) int32 = (d/dx, d/dy)."""
    p = _reflect(img.astype(np.int32), 1)
    smooth = (p[:-2] + p[2:]) * 3 + p[1:-1] * 10
    diff = p[2:] - p[:-2]
    return np.stack([smooth[:, 2:] - smooth[:, :-2],
                     (diff[:, 2:] + diff[:, :-2]) * 3 + diff[:, 1:-1] * 10], -1)


def _weights(pt: np.ndarray) -> tuple:
    """Integer corner and 14-bit bilinear weights of float32 points (n, 2)."""
    ipt = np.floor(pt).astype(np.int32)
    a, b = (pt - ipt.astype(np.float32)).T
    one, scale = np.float32(1), np.float32(1 << W_BITS)
    w00 = np.rint((one - a) * (one - b) * scale).astype(np.int32)
    w01 = np.rint(a * (one - b) * scale).astype(np.int32)
    w10 = np.rint((one - a) * b * scale).astype(np.int32)
    w11 = (1 << W_BITS) - w00 - w01 - w10
    return ipt, tuple(w[:, None, None] for w in (w00, w01, w10, w11))


def _window(img: np.ndarray, ipt: np.ndarray, weights: tuple, shift: int, pad: int) -> np.ndarray:
    """The bilinear (n, win, win) windows at corners ``ipt`` of ``img``
    (padded by ``pad``), descaled by ``shift`` bits with rounding."""
    ys = ipt[:, 1, None, None] + np.arange(LK_WIN + 1)[None, :, None] + pad
    xs = ipt[:, 0, None, None] + np.arange(LK_WIN + 1)[None, None, :] + pad
    patch = img[ys, xs]
    w00, w01, w10, w11 = weights
    acc = (patch[:, :-1, :-1] * w00 + patch[:, :-1, 1:] * w01 + patch[:, 1:, :-1] * w10
           + patch[:, 1:, 1:] * w11)
    return (acc + (1 << (shift - 1))) >> shift


def pyr_lk(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray) -> tuple:
    """``cv2.calcOpticalFlowPyrLK(prev, nxt, pts, None)`` with its defaults
    (21 x 21 window, 3 levels, 30 iterations or 0.01 px, minimum
    eigenvalue 1e-4), all points at once -> ((n, 1, 2) float32 positions,
    (n, 1) uint8 status)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    n, win, pad = len(pts), LK_WIN, LK_WIN + 1
    half = np.float32((win - 1) * 0.5)
    prev_pyr, next_pyr = pyramid(prev), pyramid(nxt)
    top = min(len(prev_pyr), len(next_pyr)) - 1
    status = np.ones(n, bool)
    out = pts.copy()
    for level in range(top, -1, -1):
        I, J = prev_pyr[level], next_pyr[level]
        rows, cols = I.shape
        Ip, Jp = _reflect(I.astype(np.int32), pad), _reflect(J.astype(np.int32), pad)
        dI = np.pad(scharr(I), [(pad, pad), (pad, pad), (0, 0)])
        p = pts * np.float32(1.0 / (1 << level))
        out = p.copy() if level == top else out * np.float32(2)
        p = p - half
        ip, wts = _weights(p)
        inside = (ip[:, 0] >= -win) & (ip[:, 0] < cols) & (ip[:, 1] >= -win) & (ip[:, 1] < rows)
        idx = np.flatnonzero(inside)
        if level == 0:
            status &= inside
        if not len(idx):
            continue
        wts = tuple(w[idx] for w in wts)
        ival = _window(Ip, ip[idx], wts, W_BITS - 5, pad)
        ix = _window(dI[..., 0], ip[idx], wts, W_BITS, pad)
        iy = _window(dI[..., 1], ip[idx], wts, W_BITS, pad)
        s = lambda v: v.reshape(len(v), -1).sum(1, dtype=np.int64).astype(np.float64)
        A11 = (s(ix * ix) * FLT_SCALE).astype(np.float32)
        A12 = (s(ix * iy) * FLT_SCALE).astype(np.float32)
        A22 = (s(iy * iy) * FLT_SCALE).astype(np.float32)
        D = A11 * A22 - A12 * A12
        min_eig = (A22 + A11 - np.sqrt((A11 - A22) * (A11 - A22) + np.float32(4) * A12 * A12)
                   ) / np.float32(2 * win * win)
        good = (min_eig >= LK_MIN_EIG) & (D >= np.finfo(np.float32).eps)
        if level == 0:
            status[idx[~good]] = False
        idx, ival, ix, iy = idx[good], ival[good], ix[good], iy[good]
        A11, A12, A22, Dinv = A11[good], A12[good], A22[good], np.float32(1) / D[good]
        q = out[idx] - half
        active = np.ones(len(idx), bool)
        prev_delta = np.zeros((len(idx), 2), np.float32)
        for j in range(LK_ITERS):
            k = np.flatnonzero(active)
            if not len(k):
                break
            iq, wq = _weights(q[k])
            ok = (iq[:, 0] >= -win) & (iq[:, 0] < cols) & (iq[:, 1] >= -win) & (iq[:, 1] < rows)
            if level == 0:
                status[idx[k[~ok]]] = False
            active[k[~ok]] = False
            k, iq, wq = k[ok], iq[ok], tuple(w[ok] for w in wq)
            if not len(k):
                break
            diff = _window(Jp, iq, wq, W_BITS - 5, pad) - ival[k]
            b1 = (s(diff * ix[k]) * FLT_SCALE).astype(np.float32)
            b2 = (s(diff * iy[k]) * FLT_SCALE).astype(np.float32)
            delta = np.stack([(A12[k] * b2 - A22[k] * b1) * Dinv[k],
                              (A12[k] * b1 - A11[k] * b2) * Dinv[k]], 1)
            q[k] += delta
            out[idx[k]] = q[k] + half
            d64 = delta.astype(np.float64)
            done = (d64 * d64).sum(1) <= LK_EPS * LK_EPS
            swing = (~done) & (j > 0) & (np.abs(delta + prev_delta[k]) < LK_EPS).all(1)
            out[idx[k[swing]]] -= delta[swing] * np.float32(0.5)
            active[k[done | swing]] = False
            prev_delta[k] = delta
    return out.reshape(-1, 1, 2), status.astype(np.uint8).reshape(-1, 1)


def _similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2 x 3 similarity through two point pairs (float64)."""
    z = src[:, 0] + 1j * src[:, 1]
    Z = dst[:, 0] + 1j * dst[:, 1]
    c = (Z[0] - Z[1]) / (z[0] - z[1])
    t = Z[0] - c * z[0]
    return np.asarray([[c.real, -c.imag, t.real], [c.imag, c.real, t.imag]])


def affine_partial_ransac(src, dst, rng: np.random.Generator, thresh: float = 3.0,
                          max_iters: int = 2000, confidence: float = 0.99) -> np.ndarray | None:
    """``cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)``: a
    4-DOF (rotation, scale, shift) fit of two-point draws from ``rng``,
    inliers within ``thresh`` px (squared error in float32), the draw count
    cut by the confidence as OpenCV does, then a least-squares fit on the
    best draw's inliers (OpenCV's Levenberg-Marquardt refinement converges
    to it: the residual is linear). -> 2 x 3 float64, or None."""
    src = np.asarray(src, np.float32).reshape(-1, 2)
    dst = np.asarray(dst, np.float32).reshape(-1, 2)
    count = len(src)
    if count < 2:
        return None
    s64, d64 = src.astype(np.float64), dst.astype(np.float64)
    best, best_good, niters, it = None, 0, max_iters, 0
    while it < niters:
        it += 1
        pick = rng.choice(count, 2, replace=False) if count > 2 else np.arange(2)
        if (src[pick[0]] == src[pick[1]]).all():
            continue
        m = _similarity(s64[pick], d64[pick]).astype(np.float32)
        e = src @ m[:, :2].T + m[:, 2] - dst
        inl = (e * e).sum(1, dtype=np.float32) <= np.float32(thresh * thresh)
        good = int(inl.sum())
        if good > max(best_good, 1):
            best, best_good = inl, good
            ep = (count - good) / count
            denom = 1.0 - (1.0 - ep) ** 2
            if denom >= np.finfo(np.float64).tiny:
                num, den = np.log(max(1.0 - confidence, np.finfo(np.float64).tiny)), np.log(denom)
                niters = (niters if den >= 0 or -num >= niters * -den
                          else int(np.rint(num / den)))
        if count == 2:
            break
    if best is None:
        return None
    p, q = s64[best], d64[best]
    one, zero = np.ones(len(p)), np.zeros(len(p))
    A = np.concatenate([np.stack([p[:, 0], -p[:, 1], one, zero], 1),
                        np.stack([p[:, 1], p[:, 0], zero, one], 1)])
    a, b, tx, ty = np.linalg.lstsq(A, np.concatenate([q[:, 0], q[:, 1]]), rcond=None)[0]
    return np.asarray([[a, -b, tx], [b, a, ty]])


class GMC:
    """Global (camera) motion compensation: ``apply(frame)`` -> the 2 x 3
    affine that maps the previous frame's coordinates into this one's
    (the identity on the first frame). Methods ``sparseOptFlow`` (the
    default: Shi-Tomasi corners of the previous gray frame, pyramidal
    Lucas-Kanade into this one, a partial-affine RANSAC fit; numpy,
    module docstring), ``orb``, ``sift``, ``ecc`` (OpenCV) and ``none``.
    Frames are RGB (or gray) uint8, worked on at 1 / ``downscale``; the
    translation is scaled back up. RANSAC draws from a generator seeded 0
    here, so a tracker's run repeats."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = None if method in ("none", "None", None) else str(method)
        self.downscale = max(1, int(downscale))
        self.rng = np.random.default_rng(0)
        if self.method in CV2_METHODS:
            cv2 = _import_cv2(self.method)
            if self.method == "orb":
                self.detector = cv2.FastFeatureDetector_create(20)
                self.extractor = cv2.ORB_create()
                self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
            elif self.method == "sift":
                self.detector = self.extractor = cv2.SIFT_create(
                    nOctaveLayers=3, contrastThreshold=0.02, edgeThreshold=20)
                self.matcher = cv2.BFMatcher(cv2.NORM_L2)
            else:
                self.warp_mode = cv2.MOTION_EUCLIDEAN
                self.criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 5000, 1e-6)
        elif self.method not in ("sparseOptFlow", None):
            raise ValueError(f"unknown GMC method {method!r}")
        self.reset()

    def reset(self) -> None:
        self.prev_gray = None
        self.prev_kps = None
        self.prev_desc = None

    def _gray(self, img) -> np.ndarray:
        gray = rgb2gray(img) if img.ndim == 3 else img
        if self.method == "ecc" and self.downscale > 1:
            gray = _import_cv2(self.method).GaussianBlur(gray, (3, 3), 1.5)
        if self.downscale > 1:
            gray = resize(gray, (gray.shape[1] // self.downscale,
                                 gray.shape[0] // self.downscale))
        return gray

    def _upscaled(self, H: np.ndarray) -> np.ndarray:
        if self.downscale > 1:
            H = H.copy()
            H[0, 2] *= self.downscale
            H[1, 2] *= self.downscale
        return H

    def apply(self, img: np.ndarray, detections=None) -> np.ndarray:
        if self.method is None or img is None:
            return np.eye(2, 3)
        if self.method in ("orb", "sift"):
            return self._apply_features(img, detections)
        if self.method == "ecc":
            return self._apply_ecc(img)
        return self._apply_sparse_flow(img)

    def _apply_sparse_flow(self, img) -> np.ndarray:
        gray = self._gray(img)
        H = np.eye(2, 3)
        if self.prev_gray is not None:
            pts = good_features(self.prev_gray, max_corners=200, quality=0.01, min_distance=10)
            if pts is not None and len(pts) >= 4:
                nxt, status = pyr_lk(self.prev_gray, gray, pts)
                good_prev = pts[status.ravel() == 1]
                good_next = nxt[status.ravel() == 1]
                if len(good_prev) >= 4:
                    m = affine_partial_ransac(good_prev, good_next, self.rng)
                    if m is not None:
                        H = self._upscaled(m)
        self.prev_gray = gray
        return H

    def _apply_ecc(self, img) -> np.ndarray:
        cv2 = _import_cv2(self.method)
        gray = self._gray(img)
        H = np.eye(2, 3, dtype=np.float32)
        if self.prev_gray is not None:
            try:
                _, H = cv2.findTransformECC(self.prev_gray, gray, H, self.warp_mode,
                                            self.criteria, None, 1)
                H = self._upscaled(H)
            except cv2.error:
                H = np.eye(2, 3, dtype=np.float32)  # no convergence: the identity
        self.prev_gray = gray
        return H

    def _apply_features(self, img, detections=None) -> np.ndarray:
        cv2 = _import_cv2(self.method)
        gray = self._gray(img)
        h, w = gray.shape
        H = np.eye(2, 3)
        # a border mask, and the detections' boxes cut out: moving objects do
        # not vote on the camera's motion
        mask = np.zeros_like(gray)
        mask[int(0.02 * h): int(0.98 * h), int(0.02 * w): int(0.98 * w)] = 255
        if detections is not None:
            for det in detections:
                x1, y1, x2, y2 = (np.asarray(det[:4]) / self.downscale).astype(int)
                mask[y1:y2, x1:x2] = 0
        kps = self.detector.detect(gray, mask)
        kps, desc = self.extractor.compute(gray, kps)
        if self.prev_desc is not None and desc is not None and len(desc) >= 2 \
                and len(self.prev_desc) >= 2:
            # Lowe's ratio test, a spatial gate (a quarter of the frame) and a
            # 2.5-sigma displacement filter, then the partial-affine RANSAC
            knn = self.matcher.knnMatch(self.prev_desc, desc, 2)
            max_dxy = 0.25 * np.asarray([w, h])
            cand, disp = [], []
            for pair in knn:
                if len(pair) < 2:
                    continue
                m, n = pair
                if m.distance < 0.9 * n.distance:
                    d = (np.asarray(self.prev_kps[m.queryIdx].pt)
                         - np.asarray(kps[m.trainIdx].pt))
                    if (np.abs(d) < max_dxy).all():
                        cand.append(m)
                        disp.append(d)
            if cand:
                disp = np.asarray(disp)
                ok = (np.abs(disp - disp.mean(0)) < 2.5 * disp.std(0) + 1e-9).all(-1)
                prev_pts = np.asarray([self.prev_kps[m.queryIdx].pt
                                       for m, k in zip(cand, ok) if k])
                curr_pts = np.asarray([kps[m.trainIdx].pt for m, k in zip(cand, ok) if k])
                if len(prev_pts) > 4:
                    m, _ = cv2.estimateAffinePartial2D(prev_pts, curr_pts, cv2.RANSAC)
                    if m is not None:
                        H = self._upscaled(m)
        self.prev_gray = gray
        self.prev_kps = kps
        self.prev_desc = desc
        return H


class BOTrack(STrack):
    """An ``STrack`` with a Kalman state over (cx, cy, w, h) and an
    exponentially smoothed, normalized ReID feature."""

    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat=None, feat_history=50):
        super().__init__(xywh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        if feat is not None:
            self.update_features(feat)
        self.alpha = 0.9

    def update_features(self, feat):
        feat = feat / np.clip(np.linalg.norm(feat), 1e-7, None)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else (
            self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        )
        self.smooth_feat /= np.clip(np.linalg.norm(self.smooth_feat), 1e-7, None)

    @staticmethod
    def tlwh_to_xyah(tlwh):
        # the state is (cx, cy, w, h): only the corner moves to the centre
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        return ret

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[:2] -= ret[2:] / 2
        return ret


class BOTSORT(BYTETracker):
    """The BoT-SORT association loop (module docstring); ``gmc_method`` is
    ``GMC``'s method, ``sparseOptFlow`` by default."""

    def __init__(self, proximity_thresh=0.5, appearance_thresh=0.25, with_reid=False,
                 gmc_method="sparseOptFlow", **kwargs):
        super().__init__(**kwargs)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid
        self.gmc = GMC(method=gmc_method)

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def init_track(self, xywhs, scores, clss, img=None):
        return [BOTrack(x, s, c) for x, s, c in zip(xywhs, scores, clss)]

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        if len(dists):
            det_scores = np.asarray([d.score for d in detections])
            dists = 1 - (1 - dists) * det_scores[None, :]
        if self.with_reid and len(tracks) and len(detections) and all(
            getattr(d, "curr_feat", None) is not None for d in detections
        ):
            emb = embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists

    def update(self, dets, img=None):
        if img is not None:
            # move the tracks' centres by the camera's motion
            H = self.gmc.apply(img)
            r = H[:2, :2]
            t = H[:2, 2]
            for track in self.tracked_stracks + self.lost_stracks:
                if track.mean is not None:
                    track.mean[:2] = r @ track.mean[:2] + t
        return super().update(dets, img)
