"""On-device augmentation of a letterboxed batch: mosaic, affine, HSV, flip.

Port of the detect path of ``xlstm_yolo_tpu/data/device_augment.py``: the
host only decodes and letterboxes to a fixed (S, S); the geometric and
photometric stages run as batched tensor ops on the step's device, before
the forward (``engine.trainer.TrainStep``), in fp32.

Pipeline, as in the JAX module (the reference's hyp names):
  1. mosaic4 within the batch: image i with images i+1, i+2, i+3 (mod B) on
     a (2S, 2S) canvas, used where the per-image mosaic draw falls under
     ``mosaic_p``; where it does not, image i padded with 114 into the
     canvas's top-left quadrant. The canvas is never built: each bilinear
     tap is gathered from the partner image that owns its quadrant.
  2. a random affine (degrees, translate, scale, shear) centred on the
     source canvas and translated into the (S, S) window, bilinear
     sampling, border 114;
  3. HSV gains (hsv_h, hsv_s, hsv_v);
  4. the horizontal flip (fliplr). ``flipud``, ``perspective`` and
     ``mixup`` are ignored, as the JAX device path ignores them.

Labels are padded (B, M, 5) cls + xyxy pixel boxes with a (B, M) mask; the
mosaic concatenates the four partners' slots (4M), the affine re-clips and
filters them (the reference's box candidates), and the first M valid slots
are packed to the front.

The random choices are apart from the arithmetic: ``draw`` returns them as
tensors (``Draws``) from an explicit ``torch.Generator`` on the step's
device; ``apply`` computes the rest from them. So a test can hand the JAX
module's own draws to ``apply`` (torch cannot reproduce ``jax.random``).
``step_generator`` seeds a step's draws from (seed, update count), as the
JAX step folds the update count into its key: a resumed run draws what the
uninterrupted run draws. Seg masks and keypoints are not ported (the port
has the detect task only).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

FILL = 114.0
# the hyp keys the JAX device path reads, with the defaults it reads them at
AUG_DEFAULTS = {"mosaic": 1.0, "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0,
                "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5}
# the seed offset of the augmentation's key in the JAX trainer
SEED_OFFSET = 7919


class Draws(NamedTuple):
    """Every random choice of one augmented batch of B images."""
    mosaic: torch.Tensor  # (B,) bool: the image takes the mosaic canvas
    fwd: torch.Tensor  # (B, 3, 3) source pixel -> output pixel
    inv: torch.Tensor  # (B, 3, 3) output pixel -> source pixel
    r: torch.Tensor  # (B, 3) HSV factors in [-1, 1)
    flip: torch.Tensor  # (B,) bool: flip left-right

    def to(self, device) -> "Draws":
        return Draws(*(t.to(device) for t in self))


def aug_hyp(hyp: dict | None) -> dict:
    """The keys of ``AUG_DEFAULTS`` from ``hyp`` as floats, a default where
    a key is missing or None."""
    hyp = hyp or {}
    return {k: float(d if hyp.get(k) is None else hyp[k]) for k, d in AUG_DEFAULTS.items()}


def step_generator(seed: int, n_updates: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from (``seed`` + SEED_OFFSET,
    ``n_updates``), the pair the JAX step folds into its key."""
    state = np.random.SeedSequence((int(seed) + SEED_OFFSET, int(n_updates))).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 31 ^ int(state[1]))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _affine_matrix(u: torch.Tensor, degrees: float, translate: float, scale: float,
                   shear: float, src: int, dst: int):
    """(fwd, inv), each (B, 3, 3), from uniforms ``u`` (B, 6) in [0, 1): the
    angle, scale, two shears and the two translations, mapped to their
    ranges as ``jax.random.uniform`` maps them. Centred on the (src, src)
    canvas, rotated, scaled and sheared, then moved to the translation in
    the (dst, dst) window (the reference's random_perspective)."""
    rng = lambda x, lo, hi: x * (hi - lo) + lo
    a = rng(u[:, 0], -degrees, degrees) * math.pi / 180.0
    s = rng(u[:, 1], 1.0 - scale, 1.0 + scale)
    shx = torch.tan(rng(u[:, 2], -shear, shear) * math.pi / 180.0)
    shy = torch.tan(rng(u[:, 3], -shear, shear) * math.pi / 180.0)
    tx = rng(u[:, 4], 0.5 - translate, 0.5 + translate) * dst
    ty = rng(u[:, 5], 0.5 - translate, 0.5 + translate) * dst

    ca, sa = torch.cos(a) * s, torch.sin(a) * s
    cx = cy = src / 2.0
    m00 = ca + shx * sa
    m01 = -sa + shx * ca
    m10 = sa + shy * ca
    m11 = ca + shy * -sa
    c0 = tx - (m00 * cx + m01 * cy)  # the canvas centre goes to (tx, ty)
    c1 = ty - (m10 * cx + m11 * cy)
    det = m00 * m11 - m01 * m10
    i00, i01, i10, i11 = m11 / det, -m01 / det, -m10 / det, m00 / det
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    fwd = torch.stack([m00, m01, c0, m10, m11, c1, zero, zero, one], -1).view(-1, 3, 3)
    inv = torch.stack([i00, i01, -(i00 * c0 + i01 * c1), i10, i11, -(i10 * c0 + i11 * c1),
                       zero, zero, one], -1).view(-1, 3, 3)
    return fwd, inv


def _sample_bilinear(imgs: torch.Tensor, inv: torch.Tensor, out_size: int,
                     mosaic: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear sampling of each image's source at ``inv`` @ (x, y, 1) of
    every output pixel; a tap outside the source is worth FILL.
    ``imgs`` (B, S, S, C) fp32, ``inv`` (B, 3, 3); returns (B, out, out, C).
    With ``mosaic`` None the source of image i is image i itself; else it is
    the (2S, 2S) canvas of ``_mosaic_canvas`` where ``mosaic`` (B,) is set,
    and image i in the top-left quadrant of a FILL canvas where it is not.
    The four taps are one gather from the flattened batch."""
    B, S, _, C = imgs.shape
    dev = imgs.device
    W = S if mosaic is None else 2 * S
    ar = torch.arange(out_size, device=dev, dtype=torch.float32)
    ys = ar.repeat_interleave(out_size)
    xs = ar.repeat(out_size)
    row = lambda i: inv[:, i, :, None]  # (B, 3, 1)
    sx = row(0)[:, 0] * xs + row(0)[:, 1] * ys + row(0)[:, 2]  # (B, N)
    sy = row(1)[:, 0] * xs + row(1)[:, 1] * ys + row(1)[:, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0

    # taps (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1): (B, 4, N); the
    # offsets made on the device (a list copied from the host would wait for it)
    tap = torch.arange(4, device=dev)[:, None]
    xi, yi = x0[:, None] + tap % 2, y0[:, None] + tap // 2
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < W)
    xi = xi.clamp(0, W - 1).long()
    yi = yi.clamp(0, W - 1).long()
    img_of = torch.arange(B, device=dev)[:, None, None]
    if mosaic is not None:
        right, lower = xi >= S, yi >= S
        img_of = torch.where(mosaic[:, None, None], (img_of + 2 * lower + right) % B, img_of)
        inb = inb & (mosaic[:, None, None] | ~(right | lower))
        xi = xi - S * right
        yi = yi - S * lower
    val = imgs.reshape(-1, C)[(img_of * S + yi) * S + xi]  # (B, 4, N, C)
    val = torch.where(inb[..., None], val, FILL)
    out = (val[:, 0] * ((1 - wx) * (1 - wy))[..., None]
           + val[:, 1] * (wx * (1 - wy))[..., None]
           + val[:, 2] * ((1 - wx) * wy)[..., None]
           + val[:, 3] * (wx * wy)[..., None])
    return out.reshape(B, out_size, out_size, C)


def _transform_boxes(boxes: torch.Tensor, mask: torch.Tensor, fwd: torch.Tensor,
                     out_size: int):
    """Boxes (B, K, 4) xyxy -> the box around their warped corners, clipped
    to the output, and the mask of those that pass the reference's
    _box_candidates (over 2 px a side, over 0.1 of their area, aspect under
    100)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx = torch.stack([x1, x2, x1, x2], -1)  # (B, K, 4 corners)
    cy = torch.stack([y1, y1, y2, y2], -1)
    f = lambda i, j: fwd[:, i, j, None, None]
    px = f(0, 0) * cx + f(0, 1) * cy + f(0, 2)
    py = f(1, 0) * cx + f(1, 1) * cy + f(1, 2)
    new = torch.stack([px.amin(-1), py.amin(-1), px.amax(-1), py.amax(-1)], -1)
    new = new.clamp(0.0, out_size)
    w_old = (x2 - x1).clamp(min=1e-6)
    h_old = (y2 - y1).clamp(min=1e-6)
    w_new = new[..., 2] - new[..., 0]
    h_new = new[..., 3] - new[..., 1]
    ar = torch.maximum(w_new / h_new.clamp(min=1e-16), h_new / w_new.clamp(min=1e-16))
    keep = (w_new > 2) & (h_new > 2) & (w_new * h_new / (w_old * h_old) > 0.1) & (ar < 100)
    return new, mask & keep


def _pack_first(cls_boxes: torch.Tensor, mask: torch.Tensor, m_out: int):
    """Valid slots to the front, in order, cut to ``m_out``."""
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :m_out]
    cb = cls_boxes.gather(1, order[..., None].expand(-1, -1, cls_boxes.shape[-1]))
    return cb, mask.gather(1, order)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

def hsv_jitter(img: torch.Tensor, r: torch.Tensor, hgain: float = 0.015, sgain: float = 0.7,
               vgain: float = 0.4) -> torch.Tensor:
    """img (B, H, W, 3) fp32 RGB 0..255; each image's gains
    ``r * gain + 1`` from its factors ``r`` (B, 3) (the reference's
    augment_hsv), applied in HSV."""
    g = lambda c, gain: (r[:, c] * gain + 1.0)[:, None, None]
    rh, rs, rv = g(0, hgain), g(1, sgain), g(2, vgain)

    x = img / 255.0
    mx = x.amax(-1)
    mn = x.amin(-1)
    diff = mx - mn
    red, green, blue = x.unbind(-1)
    safe = torch.where(diff > 0, diff, 1.0)
    h = torch.where(
        mx == red, (green - blue) / safe % 6.0,
        torch.where(mx == green, (blue - red) / safe + 2.0, (red - green) / safe + 4.0)) / 6.0
    h = torch.where(diff > 0, h, 0.0)
    s = torch.where(mx > 0, diff / mx.clamp(min=1e-12), 0.0)
    v = mx

    h = (h * rh) % 1.0
    s = (s * rs).clamp(0.0, 1.0)
    v = (v * rv).clamp(0.0, 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = (i.long() % 6)[..., None]
    pick = lambda *c: torch.stack(c, -1).gather(-1, i)[..., 0]
    rgb = torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], -1)
    return (rgb * 255.0).clamp(0.0, 255.0)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def _mosaic_canvas(cls_boxes: torch.Tensor, mask: torch.Tensor, S: int):
    """The labels of each image's (2S, 2S) mosaic canvas: the slots of
    images i, i+1, i+2, i+3 (mod B), offset into the top-left, top-right,
    bottom-left and bottom-right quadrants -> (B, 4M, 5), (B, 4M). The
    pixels are gathered by ``_sample_bilinear``."""
    B, M, _ = cls_boxes.shape
    dev = cls_boxes.device
    quad = torch.arange(4, device=dev)
    partner = (torch.arange(B, device=dev)[:, None] + quad) % B
    ox, oy = (quad % 2) * float(S), (quad // 2) * float(S)  # quadrant j's (x, y) offset
    off = torch.stack([torch.zeros_like(ox), ox, oy, ox, oy], -1)  # (4, 5): cls, x1, y1, x2, y2
    cb = (cls_boxes[partner] + off[:, None]).reshape(B, 4 * M, 5)
    return cb, mask[partner].reshape(B, 4 * M)


def draw(B: int, S: int, hyp: dict, mosaic_p: float, generator: torch.Generator) -> Draws:
    """Every random choice of a batch of B images of (S, S), on the
    generator's device: one uniform draw of (B, 11). ``hyp`` as
    ``aug_hyp``; the affine is centred on the 2S canvas where
    ``hyp["mosaic"]`` > 0 (whatever ``mosaic_p`` is, as in JAX)."""
    u = torch.rand((B, 11), generator=generator, device=generator.device)
    src = 2 * S if hyp["mosaic"] > 0.0 else S
    fwd, inv = _affine_matrix(u[:, 1:7], hyp["degrees"], hyp["translate"], hyp["scale"],
                              hyp["shear"], src, S)
    return Draws(mosaic=u[:, 0] < mosaic_p, fwd=fwd, inv=inv, r=u[:, 7:10] * 2.0 - 1.0,
                 flip=u[:, 10] < hyp["fliplr"])


def apply(imgs: torch.Tensor, cls_boxes: torch.Tensor, mask: torch.Tensor, d: Draws,
          hyp: dict):
    """The pipeline on ``d``'s choices: ``imgs`` (B, S, S, 3) 0..255,
    ``cls_boxes`` (B, M, 5) cls + xyxy pixels, ``mask`` (B, M) bool ->
    (imgs fp32 0..255, cls_boxes, mask) of the same shapes. ``hyp`` as
    ``aug_hyp``: ``mosaic`` > 0 selects the 2S canvas, the HSV gains scale
    ``d.r``."""
    B, S = imgs.shape[:2]
    M = cls_boxes.shape[1]
    imgs = imgs.float()
    if hyp["mosaic"] > 0.0:
        cb, mk = _mosaic_canvas(cls_boxes, mask, S)
        mos = d.mosaic
        own_cb = torch.cat([cls_boxes, cls_boxes.new_zeros(B, 3 * M, 5)], 1)
        own_mk = torch.cat([mask, mask.new_zeros(B, 3 * M)], 1)
        cb = torch.where(mos[:, None, None], cb, own_cb)
        mk = torch.where(mos[:, None], mk, own_mk)
        out = _sample_bilinear(imgs, d.inv, S, mos)
    else:
        cb, mk = cls_boxes, mask
        out = _sample_bilinear(imgs, d.inv, S)
    boxes, mk = _transform_boxes(cb[..., 1:5], mk, d.fwd, S)
    cb, mk = _pack_first(torch.cat([cb[..., :1], boxes], -1), mk, M)

    out = hsv_jitter(out, d.r, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])

    flip = d.flip
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    fb = torch.stack([cb[..., 0], S - cb[..., 3], cb[..., 2], S - cb[..., 1], cb[..., 4]], -1)
    cb = torch.where(flip[:, None, None], fb, cb)
    return out, cb, mk


def device_augment(batch: dict, generator: torch.Generator, hyp: dict | None = None,
                   mosaic_p: float | None = None) -> dict:
    """Augment a collated batch on its device: ``batch`` {"img" (B, S, S, 3)
    uint8 or fp32 0..255, "cls_boxes" (B, M, 5), "mask" (B, M)}; the draws
    from ``generator`` (on the batch's device), ``mosaic_p`` defaulting to
    ``hyp["mosaic"]``. Returns the batch with those three keys replaced
    (img fp32 0..255); other keys pass through."""
    hyp = aug_hyp(hyp)
    img = batch["img"]
    d = draw(img.shape[0], img.shape[1], hyp, hyp["mosaic"] if mosaic_p is None else mosaic_p,
             generator)
    img, cb, mk = apply(img, batch["cls_boxes"], batch["mask"], d, hyp)
    return {**batch, "img": img, "cls_boxes": cb, "mask": mk}
